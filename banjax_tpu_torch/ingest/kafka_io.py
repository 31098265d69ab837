"""Kafka command reader and report writer: the port's copy of
`banjax_tpu/ingest/kafka_io.py`, with the same names and behavior.

Reference behavior (Go banjax): internal/kafka.go.
  * Reader: an endless reconnect loop pinned to partition
    dnet_to_partition[dnet] (default 0) at the LAST offset, optional mTLS;
    it parses commandMessage{Name, Value, Host, SessionId, Source,
    PrintLog} and dispatches challenge_ip / block_ip / challenge_session /
    block_session into the dynamic decision lists with per-site TTL
    overrides. The reference's swapped-looking defaults are kept verbatim:
    block_ip starts from block_session_ttl_seconds and the reverse
    (kafka.go:176-192).
  * Writer: drains the report queue (the drop-don't-block producer side,
    `ingest/reports.py`) into the report topic, reconnecting on failure;
    a report taken off the queue is held across a send failure.
  Both loops reconnect on the shared capped, jittered backoff
  (`resilience/backoff.reconnect_backoff`) in place of the reference's
  flat 5 s clock, report to a health component, and check the
  `kafka.read` / `kafka.send` failpoints.

With a pipeline (`pipeline_enabled` and `pipeline_kafka`), the reader
admits each message into the scheduler's command lane
(`pipeline/scheduler.py` `submit_commands`), so commands share the lines'
backpressure and shed accounting and are dispatched on the drain thread
in admission order.

Transport: the `KafkaTransport` interface. The default is
`ingest/kafka_wire.WireKafkaTransport` (the pure-stdlib broker client);
tests inject `InMemoryTransport`, and `NullTransport` is a broker that is
never reachable. None of this touches the card.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from typing import Iterator, List, Optional

from banjax_tpu_torch.config import Config
from banjax_tpu_torch.config_holder import ConfigHolder
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.ingest.reports import get_message_queue
from banjax_tpu_torch.obs import provenance
from banjax_tpu_torch.resilience import failpoints
from banjax_tpu_torch.resilience.backoff import Backoff, reconnect_backoff
from banjax_tpu_torch.resilience.health import ComponentHealth
from banjax_tpu_torch.utils.goquery import go_query_unescape

log = logging.getLogger(__name__)

RECONNECT_SECONDS = 5  # kafka.go:169 — now a backoff-CAP input, not a fixed sleep


def _reconnect_backoff() -> Backoff:
    """The shared reconnect policy (resilience/backoff.reconnect_backoff
    — one implementation for kafka, the tailer, and fabric peers),
    capped at 6x the reference's flat 5 s clock."""
    return reconnect_backoff(cap=6 * RECONNECT_SECONDS)


def get_dnet_partition(config: Config) -> int:
    """kafka.go:47-55."""
    partition = config.dnet_to_partition.get(config.dnet)
    if partition is not None:
        log.info("KAFKA: using dnet %s mapping to partition %d", config.dnet, partition)
        return partition
    log.info("KAFKA: dnet %s not found in dnet_to_partition mapping, using partition 0",
             config.dnet)
    return 0


# ------------------------------------------------------------- transports


class KafkaTransport:
    """Minimal transport contract: blocking message iteration + send."""

    def read_messages(self, config: Config, topic: str, partition: int) -> Iterator[bytes]:
        raise NotImplementedError

    def send(self, config: Config, topic: str, value: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullTransport(KafkaTransport):
    """Behaves like a permanently-unreachable broker."""

    def read_messages(self, config: Config, topic: str, partition: int) -> Iterator[bytes]:
        raise ConnectionError("no kafka client available")

    def send(self, config: Config, topic: str, value: bytes) -> None:
        raise ConnectionError("no kafka client available")


class InMemoryTransport(KafkaTransport):
    """Test transport: push commands in, collect reports out."""

    def __init__(self) -> None:
        self.incoming: "queue.Queue[bytes]" = queue.Queue()
        self.sent: List[bytes] = []
        self._closed = threading.Event()

    def push_command(self, obj: dict) -> None:
        self.incoming.put(json.dumps(obj).encode())

    def read_messages(self, config: Config, topic: str, partition: int) -> Iterator[bytes]:
        while not self._closed.is_set():
            try:
                yield self.incoming.get(timeout=0.1)
            except queue.Empty:
                continue

    def send(self, config: Config, topic: str, value: bytes) -> None:
        self.sent.append(value)

    def close(self) -> None:
        self._closed.set()


def default_transport() -> KafkaTransport:
    from banjax_tpu_torch.ingest.kafka_wire import WireKafkaTransport

    return WireKafkaTransport()


# ----------------------------------------------------------- TTL selection


def get_block_ip_ttl(config: Config, host: str) -> int:
    """kafka.go:176-183 — note: default comes from block_session_ttl_seconds
    (reference quirk, preserved)."""
    ttl = config.sites_to_block_ip_ttl_seconds.get(host)
    if ttl is not None:
        log.info("KAFKA: found site-specific block_ip ttl %s %d", host, ttl)
        return ttl
    return config.block_session_ttl_seconds


def get_block_session_ttl(config: Config, host: str) -> int:
    """kafka.go:185-192 — default from block_ip_ttl_seconds (same quirk)."""
    ttl = config.sites_to_block_session_ttl_seconds.get(host)
    if ttl is not None:
        log.info("KAFKA: found site-specific block_session ttl %s %d", host, ttl)
        return ttl
    return config.block_ip_ttl_seconds


# ------------------------------------------------------------- dispatching


def handle_command(config: Config, command: dict, decision_lists: DynamicDecisionLists) -> None:
    """kafka.go:194-226."""
    host = command.get("host", "")
    name = command.get("Name", "")

    # reference quirk (kafka.go:200-203): the skip-and-return only fires when
    # the host is disabled AND debug is on; in production the command is
    # stored and neutralized at serve time by the DIS-BASK chain check
    if host in config.sites_to_disable_baskerville and config.debug:
        log.info("KAFKA: %s disabled baskerville, skipping %s", host, name)
        return

    if name == "challenge_ip":
        _handle_ip_command(config, command, decision_lists, Decision.CHALLENGE,
                           config.expiring_decision_ttl_seconds)
    elif name == "block_ip":
        _handle_ip_command(config, command, decision_lists, Decision.NGINX_BLOCK,
                           get_block_ip_ttl(config, host))
    elif name == "challenge_session":
        _handle_session_command(config, command, decision_lists, Decision.CHALLENGE,
                                config.expiring_decision_ttl_seconds)
    elif name == "block_session":
        _handle_session_command(config, command, decision_lists, Decision.NGINX_BLOCK,
                                get_block_session_ttl(config, host))
    elif config.debug:
        log.info("KAFKA: unrecognized command name: %s", name)


def _handle_ip_command(
    config: Config, command: dict, decision_lists: DynamicDecisionLists,
    decision: Decision, expire_duration: int,
) -> None:
    """kafka.go:228-253."""
    value = command.get("Value", "")
    if len(value) <= 4:
        log.warning("KAFKA: command value looks malformed: %s", value)
        return
    decision_lists.update(
        value,
        time.time() + expire_duration,
        decision,
        True,  # from baskerville
        command.get("host", ""),
    )
    provenance.record(
        provenance.SOURCE_KAFKA, value, decision,
        rule=command.get("Name", ""),
    )


def _handle_session_command(
    config: Config, command: dict, decision_lists: DynamicDecisionLists,
    decision: Decision, expire_duration: int,
) -> None:
    """kafka.go:255-283 — session ids are url-decoded (gin cookie parity)."""
    session_id_raw = command.get("session_id", "")
    try:
        session_id = go_query_unescape(session_id_raw)
    except ValueError:
        log.warning("KAFKA: fail to urldecode session_id %s, skip command", session_id_raw)
        return
    decision_lists.update_by_session_id(
        command.get("Value", ""),
        session_id,
        time.time() + expire_duration,
        decision,
        True,
        command.get("host", ""),
    )
    provenance.record(
        provenance.SOURCE_KAFKA, command.get("Value", ""), decision,
        rule=command.get("Name", ""),
    )


# -------------------------------------------------------------- the loops


class KafkaReader:
    """kafka.go:93-174 — reconnect loop around the transport.

    With `pipeline` set (the streaming pipeline scheduler), each received
    message is admitted into the pipeline's buffer instead of dispatched
    inline: commands then get the same bounded-block/oldest-first-shed
    backpressure accounting as tailer lines (admitted == processed + shed
    spans both producers) and execute on the drain thread in admission
    order.  Without a pipeline the reference's inline dispatch is kept."""

    def __init__(
        self,
        config_holder: ConfigHolder,
        decision_lists: DynamicDecisionLists,
        transport: Optional[KafkaTransport] = None,
        backoff: Optional[Backoff] = None,
        health: Optional[ComponentHealth] = None,
        pipeline=None,
    ):
        self.config_holder = config_holder
        self.decision_lists = decision_lists
        self.transport = transport or default_transport()
        self.backoff = backoff or _reconnect_backoff()
        self.health = health
        self.pipeline = pipeline
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="kafka-reader", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.transport.close()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def _run(self) -> None:
        while not self._stop.is_set():
            config = self.config_holder.get()
            partition = get_dnet_partition(config)
            try:
                failpoints.check("kafka.read")
                for raw in self.transport.read_messages(
                    config, config.kafka_command_topic, partition
                ):
                    if self._stop.is_set():
                        return
                    # a delivered message is the success signal: reset the
                    # reconnect backoff and report healthy
                    self.backoff.reset()
                    if self.health is not None:
                        self.health.ok()
                    if self.pipeline is not None:
                        # admission-buffer path: backpressure + shed
                        # accounting shared with the tailer; dispatched by
                        # the drain stage in admission order
                        self.pipeline.submit_commands([raw], self.dispatch_raw)
                    else:
                        self.dispatch_raw(raw)
            except Exception as e:  # noqa: BLE001 — any transport failure → reconnect
                log.warning("KAFKA: reader failed: %s", e)
                if self.health is not None:
                    self.health.degraded(f"reconnecting: {e}")
            if self.backoff.wait(self._stop):
                return
            log.info("KAFKA: reconnecting kafka reader (attempt %d)",
                     self.backoff.attempt)

    def dispatch_raw(self, raw: bytes) -> None:
        """Parse + dispatch one command message (the reference's loop
        body).  Own method so the pipeline's drain stage can run it per
        admitted message; a malformed message loses itself, never the
        stream."""
        config = self.config_holder.get()
        try:
            command = json.loads(raw)
        except json.JSONDecodeError:
            log.warning("KAFKA: unmarshal failed: %r", raw[:200])
            return
        if not isinstance(command, dict):
            return
        if config.debug or command.get("print_log"):
            log.info("KAFKA: message N: %s, V: %s, S: %s, Src: %s",
                     command.get("Name"), command.get("Value"),
                     command.get("session_id"), command.get("source"))
        handle_command(config, command, self.decision_lists)


class KafkaWriter:
    """kafka.go:353-406 — drain the report queue into the report topic."""

    def __init__(
        self,
        config_holder: ConfigHolder,
        transport: Optional[KafkaTransport] = None,
        backoff: Optional[Backoff] = None,
        health: Optional[ComponentHealth] = None,
    ):
        self.config_holder = config_holder
        self.transport = transport or default_transport()
        self.backoff = backoff or _reconnect_backoff()
        self.health = health
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="kafka-writer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.transport.close()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def _run(self) -> None:
        message_queue = get_message_queue()
        # the dequeued-but-unsent report: held across a transport failure
        # and retried first after reconnect, so a send crash never drops
        # the in-flight message (the producer side is drop-don't-block;
        # the drain side must not lose what it already accepted)
        pending: Optional[bytes] = None
        while not self._stop.is_set():
            config = self.config_holder.get()
            try:
                while not self._stop.is_set():
                    if pending is None:
                        try:
                            pending = message_queue.get(timeout=0.2)
                        except queue.Empty:
                            continue
                    failpoints.check("kafka.send")
                    self.transport.send(config, config.kafka_report_topic, pending)
                    pending = None
                    self.backoff.reset()
                    if self.health is not None:
                        self.health.ok()
            except Exception as e:  # noqa: BLE001 — any transport failure → reconnect
                log.warning("KAFKA: writer failed: %s%s", e,
                            " (1 report held for retry)" if pending else "")
                if self.health is not None:
                    self.health.degraded(f"reconnecting: {e}")
            if self.backoff.wait(self._stop):
                return
