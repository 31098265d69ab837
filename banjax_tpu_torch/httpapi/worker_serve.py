"""HTTP worker process (`python -m banjax_tpu_torch.httpapi.worker_serve`): the
port's copy of `banjax_tpu/httpapi/worker_serve.py`.

One of N SO_REUSEPORT processes serving the /auth_request hot path (see
`httpapi/workers.py`). A worker builds only host state: the config, the
static lists, a replica of the dynamic lists, the shared failed-challenge
table and the serving decision table (both attached by name), a
forwarding banner and a reports forwarder. The matcher, the tailer, the
Kafka channel, the ipset and the metrics all live in the primary. A
worker never touches the card: PoW cookies are checked on the host (no
verifier), as in JAX, it imports no torch (as a JAX worker imports no
jax), and the supervisor starts it with no CUDA device visible. It binds
the port the primary bound (`-port`).

A table that cannot be attached raises and the worker exits, for the
supervisor to respawn (the JAX worker serves through the chain instead).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import sys
from typing import Optional

from banjax_tpu_torch.cli import NoStates
from banjax_tpu_torch.config_holder import ConfigHolder
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.protected_paths import PasswordProtectedPaths
from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
from banjax_tpu_torch.httpapi.server import ServerDeps, run_http_server
from banjax_tpu_torch.httpapi.workers import PRIMARY_HTTP_SOCK, RemoteBanner, WorkerControl
from banjax_tpu_torch.ingest import reports
from banjax_tpu_torch.native.decisiontable import ShmDecisionTable
from banjax_tpu_torch.native.shm import ShmFailedChallengeStates
from banjax_tpu_torch.obs import provenance

log = logging.getLogger(__name__)


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(prog="banjax-tpu-torch-worker", prefix_chars="-")
    parser.add_argument("-config-file", dest="config_file", required=True)
    parser.add_argument("-ctrl-dir", dest="ctrl_dir", required=True)
    parser.add_argument("-index", dest="index", type=int, required=True)
    parser.add_argument("-shm-name", dest="shm_name", required=True)
    parser.add_argument("-dt-shm-name", dest="dt_shm_name", default="")
    parser.add_argument("-port", dest="port", type=int, required=True)
    parser.add_argument("-standalone-testing", dest="standalone_testing",
                        action="store_true")
    parser.add_argument("-debug", dest="debug", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format=f"%(asctime)s worker-{args.index} %(name)s %(levelname)s %(message)s",
    )

    config_holder = ConfigHolder(args.config_file, args.standalone_testing, args.debug)
    config = config_holder.get()
    # the chain records its provenance in this process's ledger; the
    # primary re-records the authoritative inserts it applies and serves
    # /decisions/explain
    provenance.configure(enabled=config.provenance_enabled,
                         ring_size=config.provenance_ring_size)

    static_lists = StaticDecisionLists(config)
    protected_paths = PasswordProtectedPaths(config)
    replica = DynamicDecisionLists()
    failed_challenge_states = ShmFailedChallengeStates(name=args.shm_name)
    # the primary's serving table, read only: the replica does not mirror
    # (the primary already wrote every broadcast insert into the table)
    decision_table = ShmDecisionTable(name=args.dt_shm_name) if args.dt_shm_name else None

    def on_reload() -> None:
        log.info("worker %d: reloading config", args.index)
        try:
            config_holder.reload()
        except Exception as e:  # noqa: BLE001 — keep serving on a bad reload
            log.error("worker reload failed: %s", e)
            return
        new_config = config_holder.get()
        static_lists.update_from_config(new_config)
        protected_paths.update_from_config(new_config)
        # the replica is cleared by the primary's dyn_clear broadcast

    control = WorkerControl(args.ctrl_dir, args.index, replica, on_reload)
    banner = RemoteBanner(control, replica)
    # this worker's Kafka reports ride the control socket to the primary
    reports.set_forwarder(
        lambda data: control.send({"op": "kafka", "data": data.decode("utf-8")})
    )

    gin_log_file = None
    gin_log_name = "gin.log" if config.standalone_testing else config.gin_log_file
    if gin_log_name and gin_log_name != "-":
        # O_APPEND: every worker and the primary append whole lines
        gin_log_file = open(gin_log_name, "a", encoding="utf-8")
    server_log_file = None
    if config.standalone_testing:
        server_log_file = open(config.server_log_file, "a", encoding="utf-8")

    deps = ServerDeps(
        config_holder=config_holder,
        static_lists=static_lists,
        dynamic_lists=replica,
        protected_paths=protected_paths,
        regex_states=NoStates(),  # primary-owned; the route is proxied
        failed_challenge_states=failed_challenge_states,
        banner=banner,
        gin_log_file=gin_log_file,
        server_log_file=server_log_file,
        challenge_verifier=None,  # the host check: workers never touch the card
        decision_table=decision_table,
    )
    primary_sock = os.path.join(args.ctrl_dir, PRIMARY_HTTP_SOCK)

    async def serve() -> None:
        handle = await run_http_server(deps, port=args.port, reuse_port=True,
                                       worker_proxy_sock=primary_sock)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        log.info("worker %d serving on port %d", args.index, handle.port)
        control.send({"op": "ready", "index": args.index, "pid": os.getpid()})
        await stop.wait()
        await handle.cleanup()

    try:
        asyncio.run(serve())
    finally:
        control.stop()
        replica.close()
        failed_challenge_states.close()
        if decision_table is not None:
            decision_table.close()
        for f in (gin_log_file, server_log_file):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
