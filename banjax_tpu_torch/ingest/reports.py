"""Kafka report messages and the drop-don't-block producer queue.

Reference behavior (Go banjax): internal/kafka.go:285-350 — challenge
outcome events (ip_passed_challenge / ip_failed_challenge / ip_banned) and
a 19 s status heartbeat are marshalled to JSON and handed to the writer through
a channel with a NON-BLOCKING send: when the writer goroutine isn't draining
(disconnected, not started), messages are dropped, never queued unboundedly
and never blocking the request path.

Here the channel is a small bounded queue drained by the Kafka writer
(`ingest/kafka_io.py` `KafkaWriter`); put_nowait + drop-on-full
reproduces the drop-don't-block property. In an HTTP worker process
(`httpapi/worker_serve.py`) no writer drains it: `set_forwarder` routes
the report bytes to the primary's control socket instead. A copy of
`banjax_tpu/ingest/reports.py`.
"""

from __future__ import annotations

import json
import logging
import queue
import time

from banjax_tpu_torch.config import Config

log = logging.getLogger(__name__)

# module-level like the reference's global messageChan (kafka.go:349-350)
_message_queue: "queue.Queue[bytes]" = queue.Queue(maxsize=256)

# set in an HTTP worker process, where no Kafka writer drains the queue
_forwarder = None


def set_forwarder(fn) -> None:
    """Route report bytes through `fn` instead of the local queue (a worker
    forwards them to the primary's control socket); None restores the queue."""
    global _forwarder
    _forwarder = fn


def get_message_queue() -> "queue.Queue[bytes]":
    return _message_queue


def _send_bytes(data: bytes) -> None:
    """Non-blocking send; drop when the writer isn't draining (kafka.go:334-346)."""
    if _forwarder is not None:
        _forwarder(data)
        return
    try:
        _message_queue.put_nowait(data)
    except queue.Full:
        log.debug("KAFKA: did not put message on queue (writer not draining)")


def report_status_message(config: Config) -> None:
    """kafka.go:291-306 — the `status` heartbeat."""
    message = {
        "id": config.hostname,
        "name": "status",
        "timestamp": int(time.time()),
    }
    _send_bytes(json.dumps(message).encode())


def report_passed_failed_banned_message(config: Config, name: str, ip: str, site: str) -> None:
    """kafka.go:308-332 — name is ip_passed_challenge, ip_failed_challenge,
    or ip_banned."""
    if config.disable_kafka:
        return
    message = {
        "id": config.hostname,
        "name": name,
        "value_ip": ip,
        "value_site": site,
        "timestamp": int(time.time()),
    }
    _send_bytes(json.dumps(message).encode())
