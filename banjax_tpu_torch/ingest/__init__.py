"""Ingest: the log tailer, challenge-outcome reports (the queue), the Kafka
command reader and report writer (`kafka_io`), and the broker wire client
(`kafka_wire`)."""
