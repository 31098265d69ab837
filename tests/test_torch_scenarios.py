"""The scenario harness: the port's `banjax_tpu_torch/scenarios/` against
the JAX package's, on the CPU, tolerance 0.

- Shapes: every `SHAPES` entry at scale 0.2 and the mega stream at 4,096
  distinct IPs give the byte-identical line stream, command events,
  rotation markers and notes.
- The oracle's expected ban multiset and the chaos schedules' rows equal
  JAX's.
- `ScenarioRunner` on the CPU (the kernels' plain versions) gives the JAX
  runner's (`matcher_backend: xla`) ban multiset and the oracle's on
  flash_crowd (also with single_kernel "off", the two-program mode),
  benign (single_kernel auto and on) and
  challenge_storm with its challenge loop; the tailer and Kafka modes
  against the oracle; a seeded chaos run with `matcher.device` episodes
  closes the accounting with the refused lines in drain_error_lines and
  holds the JAX soak's other gates.
"""

import dataclasses
import os
from collections import Counter

import pytest

from banjax_tpu.config.schema import config_from_yaml_text as jax_config
from banjax_tpu.resilience import failpoints as jax_fp
from banjax_tpu.scenarios import ScenarioRunner as JaxRunner
from banjax_tpu.scenarios import chaos as jax_chaos
from banjax_tpu.scenarios import oracle as jax_oracle
from banjax_tpu.scenarios import shapes as jax_shapes
from banjax_tpu_torch.config import config_from_yaml_text
from banjax_tpu_torch.ingest.broker_standin import KafkaBrokerStandIn
from banjax_tpu_torch.obs import exposition
from banjax_tpu_torch.resilience import failpoints as port_fp
from banjax_tpu_torch.scenarios import ScenarioRunner, chaos, oracle, shapes
from banjax_tpu_torch.scenarios import stats as scen_stats
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401
from tests.test_torch_obs import obs_reset  # noqa: F401

SEED = 20260804  # the JAX soak's committed seed


@pytest.fixture(autouse=True)
def _scenario_state():
    """Failpoints and the scenario counters are process-wide: start and
    end clean."""
    jax_fp.disarm()
    port_fp.disarm()
    scen_stats.get_stats().reset()
    yield
    jax_fp.disarm()
    port_fp.disarm()
    scen_stats.get_stats().reset()


def _events(sc):
    out = []
    for ev in sc.events:
        kind = type(ev).__name__
        body = getattr(ev, "lines", None) or getattr(ev, "raws", None) or ()
        out.append((kind, tuple(body)))
    return out


# ------------------------------------------------------------ the shapes


@pytest.mark.parametrize("name", sorted(jax_shapes.SHAPES))
def test_shape_stream_is_byte_identical_to_jax(name):
    p = shapes.generate(name, SEED, 0.2)
    j = jax_shapes.generate(name, SEED, 0.2)
    assert _events(p) == _events(j)
    assert "\n".join(p.lines()).encode() == "\n".join(j.lines()).encode()
    assert (p.name, p.seed, p.scale, p.rules_yaml, p.benign, p.expected_command_ips, p.notes) \
        == (j.name, j.seed, j.scale, j.rules_yaml, j.benign, j.expected_command_ips, j.notes)
    assert p.n_commands() == j.n_commands()


def test_mega_stream_and_offenders_are_byte_identical_to_jax():
    p = list(shapes.mega_rotating_proxies_stream(SEED, 4096, chunk=1000))
    j = list(jax_shapes.mega_rotating_proxies_stream(SEED, 4096, chunk=1000))
    assert p == j and sum(map(len, p)) == 4096 + 3 * shapes.MEGA_OFFENDER_HITS
    po, jo = shapes.mega_offenders(SEED), jax_shapes.mega_offenders(SEED)
    assert _events(po) == _events(jo) and po.notes == jo.notes
    assert (shapes.T0, shapes.RUN_NOW, shapes.SPAN_S, shapes.CHUNK_LINES, shapes.RULES_YAML) == (
        jax_shapes.T0, jax_shapes.RUN_NOW, jax_shapes.SPAN_S, jax_shapes.CHUNK_LINES,
        jax_shapes.RULES_YAML)


def test_unknown_shape_raises_like_jax():
    with pytest.raises(ValueError, match="unknown scenario"):
        shapes.generate("no_such_shape")


# ------------------------------------------------------------ the oracle


@pytest.mark.parametrize("name", sorted(jax_shapes.SHAPES))
def test_oracle_bans_equal_jax(name):
    p = shapes.generate(name, SEED, 0.5)
    j = jax_shapes.generate(name, SEED, 0.5)
    got = oracle.expected_bans(p, config_from_yaml_text(p.rules_yaml))
    want = jax_oracle.expected_bans(j, jax_config(j.rules_yaml))
    assert got == want
    assert (len(got) == 0) == (name == "benign")


def test_mega_offenders_oracle_equals_jax():
    got = oracle.expected_bans(shapes.mega_offenders(SEED),
                               config_from_yaml_text(shapes.RULES_YAML))
    want = jax_oracle.expected_bans(jax_shapes.mega_offenders(SEED),
                                    jax_config(jax_shapes.RULES_YAML))
    assert got == want and len(got) == 3


def test_precision_recall_equals_jax():
    eng = [("a", "r"), ("a", "r"), ("b", "r"), ("c", "q")]
    orc = [("a", "r"), ("b", "r"), ("b", "r"), ("d", "q")]
    for e, o in ((eng, orc), ([], orc), (eng, []), ([], [])):
        assert oracle.precision_recall(e, o) == jax_oracle.precision_recall(e, o)


# ---------------------------------------------------------- the schedules


@pytest.mark.parametrize("seed", [SEED, SEED + 1, 7])
def test_chaos_schedule_rows_equal_jax(seed):
    for points in (chaos.PIPELINE_POINTS, chaos.TAILER_POINTS, chaos.KAFKA_POINTS):
        for n_events, episodes in ((12, 4), (3, 6), (40, 6)):
            p = chaos.ChaosSchedule(seed, n_events, points=points, episodes=episodes)
            j = jax_chaos.ChaosSchedule(seed, n_events, points=points, episodes=episodes)
            assert p.rows() == j.rows()
    assert chaos.MembershipChurnSchedule(seed).rows() == \
        jax_chaos.MembershipChurnSchedule(seed).rows()


def test_point_tuples_equal_jax_and_are_known_failpoints():
    for name in ("PIPELINE_POINTS", "TAILER_POINTS", "KAFKA_POINTS", "GOSSIP_POINTS"):
        assert getattr(chaos, name) == getattr(jax_chaos, name)
        assert set(getattr(chaos, name)) <= set(port_fp.KNOWN_SITES)


# ---------------------------------------------------------- the runner


def _jax_run(sc, **kw):
    over = dict(kw.pop("cfg_overrides", None) or {}, matcher_backend="xla")
    return JaxRunner(sc, cfg_overrides=over, **kw).run()


def _check_clean(rep):
    bad = {k: v for k, v in rep.invariants.items() if not v}
    assert not bad, (rep.name, bad)
    assert rep.precision == 1.0 and rep.recall == 1.0, rep.name
    assert rep.shed_lines == 0 and rep.drain_error_lines == 0 and rep.refused_lines == 0


def test_flash_crowd_bans_equal_jax_and_the_oracle():
    rep = ScenarioRunner(shapes.generate("flash_crowd", SEED, 0.25), device="cpu").run()
    jrep = _jax_run(jax_shapes.generate("flash_crowd", SEED, 0.25))
    _check_clean(rep)
    assert rep.oracle_bans > 0 and rep.engine_bans == rep.oracle_bans
    assert (rep.engine_bans, rep.true_positives, rep.n_lines) == \
        (jrep.engine_bans, jrep.true_positives, jrep.n_lines)
    assert rep.invariants.keys() == jrep.invariants.keys()


@pytest.mark.parametrize("single_kernel", ["auto", "on"])
def test_benign_gives_no_bans_and_a_clean_slo_board(single_kernel):
    sc = shapes.generate("benign", SEED, 0.1)
    rep = ScenarioRunner(sc, device="cpu", single_kernel=single_kernel).run()
    jrep = _jax_run(jax_shapes.generate("benign", SEED, 0.1), single_kernel=single_kernel)
    _check_clean(rep)
    assert rep.engine_bans == jrep.engine_bans == 0
    assert not any(rep.slo_breached.values())
    assert rep.slo_breached.keys() == jrep.slo_breached.keys()


def test_single_kernel_off_raises():
    """single_kernel "off" runs the two-program mode (program A at submit,
    program B at the drain), as the JAX soak does: flash_crowd's bans
    equal JAX's two-program run's and the oracle's, with every chunk
    committed by program B or its counted classic fallback."""
    rep = ScenarioRunner(shapes.generate("flash_crowd", SEED, 0.25), device="cpu",
                         single_kernel="off").run()
    jrep = _jax_run(jax_shapes.generate("flash_crowd", SEED, 0.25), single_kernel="off")
    _check_clean(rep)
    assert rep.oracle_bans > 0 and rep.engine_bans == rep.oracle_bans
    assert (rep.engine_bans, rep.true_positives, rep.n_lines) == \
        (jrep.engine_bans, jrep.true_positives, jrep.n_lines)
    assert rep.single_kernel == "off"


def test_challenge_storm_loop_equals_jax(tmp_path):
    over = {"challenge_failure_state_max": 4}
    rep = ScenarioRunner(shapes.generate("challenge_storm", SEED, 0.25), device="cpu",
                         flightrec_dir=str(tmp_path / "port"), cfg_overrides=over).run()
    jrep = _jax_run(jax_shapes.generate("challenge_storm", SEED, 0.25),
                    flightrec_dir=str(tmp_path / "jax"), cfg_overrides=over)
    _check_clean(rep)
    assert rep.challenge == jrep.challenge
    ch = rep.challenge
    assert ch["verify_path"] == "cpu" and ch["solver_passes"] == ch["solvers"] > 0
    assert ch["banned"] == ch["attackers"] > 0 and ch["failure_state_entries"] <= 4
    assert rep.engine_bans == jrep.engine_bans == rep.oracle_bans > 0


def test_challenge_storm_verified_by_the_device_path(tmp_path):
    """With challenge_device_verify the solvers' cookies go through the
    verifier (kernel C's plain version on the CPU): the same decisions."""
    rep = ScenarioRunner(shapes.generate("challenge_storm", SEED, 0.25), device="cpu",
                         cfg_overrides={"challenge_device_verify": True}).run()
    base = ScenarioRunner(shapes.generate("challenge_storm", SEED, 0.25), device="cpu").run()
    _check_clean(rep)
    assert rep.challenge["verify_path"] == "device"
    assert {k: v for k, v in rep.challenge.items() if k != "verify_path"} == \
        {k: v for k, v in base.challenge.items() if k != "verify_path"}


def test_log_rotation_through_the_tailer_matches_the_oracle(tmp_path):
    sc = shapes.generate("log_rotation", SEED, 0.25)
    assert sc.notes["rotations"] >= 1
    rep = ScenarioRunner(sc, device="cpu", via_tailer=True, tmp_dir=str(tmp_path)).run()
    _check_clean(rep)
    assert rep.mode == "tailer" and rep.oracle_bans > 0


def test_command_flood_through_the_broker_stand_in():
    broker = KafkaBrokerStandIn().start()
    try:
        rep = ScenarioRunner(shapes.generate("command_flood", SEED, 0.1), device="cpu",
                             kafka_broker=broker).run()
        reports = broker.log_end_offset("scenario.reports")
    finally:
        broker.stop()
    _check_clean(rep)
    assert rep.mode == "kafka" and rep.command_items == rep.n_commands > 0
    assert reports >= 2


def test_command_flood_direct_drains_every_command():
    rep = ScenarioRunner(shapes.generate("command_flood", SEED, 0.1), device="cpu").run()
    _check_clean(rep)
    assert rep.command_items == rep.n_commands > 0


def test_chaos_run_counts_refused_lines_as_drain_errors(tmp_path):
    """A seeded `matcher.device` episode: the failed and refused batches
    land in drain_error_lines (the JAX runner reruns them on its host
    matcher), the accounting closes, every episode leaves a bundle,
    episodes fired and nothing is left armed. Precision and recall are
    reported, not gated."""
    sc = shapes.generate("flash_crowd", SEED, 0.25)
    sched = chaos.ChaosSchedule(seed=SEED, n_events=len(sc.events),
                                points=("matcher.device",), episodes=3)
    rep = ScenarioRunner(sc, device="cpu", chaos=sched,
                         flightrec_dir=str(tmp_path / "fr")).run()
    bad = {k: v for k, v in rep.invariants.items() if not v}
    assert not bad, bad
    assert rep.invariants["accounting"] and rep.invariants["bundle_per_episode"]
    assert rep.drain_error_lines > 0 and rep.fallback_batches >= 0
    assert sum(ep["fired"] for ep in rep.episodes) > 0
    assert all(ep["bundle"] for ep in rep.episodes)
    assert rep.incidents >= len(rep.episodes)
    assert not any(fp["count"] for fp in port_fp.snapshot())
    for name in os.listdir(tmp_path / "fr"):
        assert os.path.exists(tmp_path / "fr" / name / "meta.json")
    assert 0.0 <= rep.precision <= 1.0 and 0.0 <= rep.recall <= 1.0


def test_scenario_families_render_after_a_run():
    rep = ScenarioRunner(shapes.generate("benign", SEED, 0.1), device="cpu").run()
    runner = ScenarioRunner(shapes.generate("benign", SEED, 0.1), device="cpu")
    runner._build()
    try:
        text = runner._metrics_text()
    finally:
        runner.matcher.close()
    fams = exposition.parse_text_format(text)
    assert fams["banjax_scenario_runs_total"]["samples"][0][2] == 1.0
    assert any(lab.get("scenario") == "benign"
               for _, lab, _ in fams["banjax_scenario_ban_recall"]["samples"])
    assert rep.row()["name"] == "benign" and dataclasses.is_dataclass(rep)


def test_ban_multiset_of_a_clean_run_equals_the_oracle_multiset():
    sc = shapes.generate("slow_drip", SEED, 0.3)
    runner = ScenarioRunner(sc, device="cpu")
    rep = runner.run()
    _check_clean(rep)
    want = oracle.expected_bans(sc, runner.cfg)
    assert Counter(runner.banner.regex_ban_logs) == Counter(want) and 0 < len(want) < 10
