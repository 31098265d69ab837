"""The fabric dry run: the port's `fabric/{worker,harness}.py` against the
JAX harness, with real worker processes on the CPU.

- Two workers each (flash_crowd, scale 0.25, no kill, wire v2): the port's
  ban multiset equals the JAX harness's and the oracle's, and every ledger
  closes.
- The port alone with a SIGKILL mid-flood and a rejoin from a snapshot:
  recall 1.0, a completed takeover, closed accounting, the wave after the
  rejoin processed exactly once.
- A worker asked for the card where there is none raises (in process,
  no worker spawned).
"""

import json
from collections import Counter

import pytest
import torch

from banjax_tpu.fabric.harness import run_fabric as jax_run_fabric
from banjax_tpu_torch.config import config_from_yaml_text
from banjax_tpu_torch.fabric import worker
from banjax_tpu_torch.fabric.harness import run_fabric
from banjax_tpu_torch.scenarios import oracle, shapes

SEED = 20260804


def _assert_invariants(report):
    bad = {k: v for k, v in report["invariants"].items() if not v}
    assert not bad, f"{bad}\n{json.dumps(report, indent=1, default=str)[:4000]}"


def _oracle_log(shape, scale):
    sc = shapes.generate(shape, SEED, scale)
    bans = oracle.expected_bans(sc, config_from_yaml_text(sc.rules_yaml))
    return sorted(f"{ip} {rule}" for ip, rule in bans)


def test_two_workers_give_the_jax_harness_bans(tmp_path):
    kw = dict(n_workers=2, shape="flash_crowd", seed=SEED, scale=0.25, kill=False)
    port = run_fabric(device="cpu", log_dir=str(tmp_path / "port"), **kw)
    ref = jax_run_fabric(log_dir=str(tmp_path / "jax"), **kw)
    _assert_invariants(port)
    assert Counter(port["ban_log"]) == Counter(ref["ban_log"])
    assert port["ban_log"] == _oracle_log("flash_crowd", 0.25) and port["oracle_bans"] > 0
    assert (port["recall"], port["precision"]) == (ref["recall"], ref["precision"]) == (1.0, 1.0)
    assert port["fed_lines"] == port["acked_lines"] == ref["fed_lines"]
    assert {k for k in port["invariants"] if not k.endswith("fed_equals_acked")} == \
        {k for k in ref["invariants"] if not k.endswith("fed_equals_acked")}
    # the plain versions on the CPU launch no kernel; nothing was sent twice
    assert port["launches"] == {"nfa_match": 0, "window_scan": 0, "pow_verify": 0}
    assert port["resent"] == {"frames": 0, "lines": 0}


def test_kill_mid_flood_and_rejoin_keep_every_ban(tmp_path):
    report = run_fabric(n_workers=2, shape="flash_crowd", seed=SEED, scale=0.25,
                        kill=True, rejoin=True, device="cpu", log_dir=str(tmp_path))
    _assert_invariants(report)
    assert report["recall"] == 1.0 and report["oracle_bans"] > 0
    assert report["fed_lines"] == report["acked_lines"]
    assert report["takeover"]["victim"] == "w1"
    assert report["takeover"]["shed_ratio_in_window"] == 0.0
    rejoin = report["rejoin"]
    assert all(rejoin["invariants"].values()), rejoin
    assert rejoin["sync_applied"] == rejoin["snapshot_decisions"] > 0
    assert rejoin["newcomer_local_lines"] > 0


def test_worker_asked_for_the_card_without_one_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--node-id", "w9"])
    ready = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ready["ready"] is False and "cuda:0" in ready["error"]


def test_harness_refuses_an_unknown_transport():
    with pytest.raises(ValueError, match="unknown transport"):
        run_fabric(transport="carrier-pigeon", device="cpu")
