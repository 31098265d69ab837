"""Challenge-outcome reports (the queue; no Kafka client yet)."""
