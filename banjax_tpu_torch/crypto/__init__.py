"""Challenge-cookie crypto, session cookies and the integrity bot score."""
