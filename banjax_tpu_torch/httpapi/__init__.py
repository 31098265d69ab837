"""The /auth_request decision chain, its page rewriting and its pages."""
