"""The port stands alone: no module of `banjax_tpu_torch` and not
`chip_smoke.py` imports JAX or the JAX package, entry points refuse to run
on the host when no GPU was asked for, and the kernel wrappers refuse what
they cannot launch instead of falling back."""

import ast
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers, and the timing-sensitive tests beside these need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "banjax_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if fname in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((ROOT / "banjax_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    scanned = {p.relative_to(ROOT / "banjax_tpu_torch").parts[0] for p in files[:-1]}
    assert scanned >= {"challenge", "crypto", "decisions", "effectors", "fabric", "httpapi",
                       "ingest", "matcher", "native", "obs", "parallel", "utils"}
    names = {str(p.relative_to(ROOT)) for p in files}
    assert names >= {"banjax_tpu_torch/ingest/kafka_wire.py", "banjax_tpu_torch/ingest/kafka_io.py",
                     "banjax_tpu_torch/httpapi/workers.py",
                     "banjax_tpu_torch/httpapi/worker_serve.py", "chip_smoke.py",
                     "banjax_tpu_torch/obs/fleet.py", "banjax_tpu_torch/native/shmring.py"} | {
        f"banjax_tpu_torch/fabric/{m}.py" for m in (
            "__init__", "hashring", "wire", "stats", "node", "peer", "replication", "router",
            "membership", "service", "worker", "harness")} | {
        f"banjax_tpu_torch/scenarios/{m}.py" for m in (
            "__init__", "shapes", "oracle", "runtime", "chaos", "stats")} | {
        "banjax_tpu_torch/matcher/fused.py", "banjax_tpu_torch/ingest/broker_standin.py",
        "banjax_tpu_torch/parallel/__init__.py", "banjax_tpu_torch/parallel/mesh.py"}
    bad = [(str(p.relative_to(ROOT)), m) for p in files for m in _imports(p) if _forbidden(m)]
    assert not bad, bad


def test_matcher_without_a_device_raises_when_no_gpu(monkeypatch):
    from banjax_tpu_torch.config import config_from_yaml_text
    from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
    from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
    from banjax_tpu_torch.effectors.banner import Banner
    from banjax_tpu_torch.matcher.runner import TorchMatcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_from_yaml_text(
        "matcher: tpu\nmatcher_device_windows: true\nregexes_with_rates:\n"
        "  - {rule: r, regex: 'GET /admin', interval: 5, hits_per_interval: 1,"
        " decision: challenge}\n"
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchMatcher(cfg, Banner(DynamicDecisionLists(start_sweeper=False), None, None),
                     StaticDecisionLists(cfg))


def test_kernel_wrappers_refuse_instead_of_falling_back():
    from banjax_tpu_torch.matcher.kernels import fused_match_window, nfa_match
    from banjax_tpu_torch.matcher.rulec import compile_rules

    prep = nfa_match.prepare(compile_rules(["GET /admin"]), "cpu")
    with pytest.raises(TypeError):
        nfa_match.accept_words(prep, torch.zeros((2, 8), dtype=torch.int64),
                               torch.zeros(2, dtype=torch.int32))
    meta = [torch.zeros(4, dtype=torch.int32, device="meta")] * 11
    with pytest.raises(ValueError, match="unsupported device"):
        fused_match_window.window_scan(meta)


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _libraries():
    """Every library object the port defines, found on its modules."""
    import importlib

    from banjax_tpu_torch.matcher.kernels import _build

    found = {}
    for path in sorted((ROOT / "banjax_tpu_torch").rglob("*.py")):
        mod = importlib.import_module(
            ".".join(path.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        )
        for value in vars(mod).values():
            if isinstance(value, _build.CudaLibrary):
                found[value.name] = value
    return found


def test_every_compiled_source_lies_in_the_port():
    libs = _libraries()
    assert set(libs) >= {"nfa_match", "window_scan", "pow_verify", "fastparse", "slotmgr",
                         "shmstate", "shmring"}
    port = (ROOT / "banjax_tpu_torch").resolve()
    for lib in libs.values():
        assert lib.source.resolve().is_relative_to(port) and lib.source.exists(), lib.name
        assert lib.path.resolve().is_relative_to((ROOT / "build").resolve()), lib.name
    on_disk = {p.name for p in port.rglob("*.c")} | {p.name for p in port.rglob("*.cu")}
    assert on_disk == {lib.source.name for lib in libs.values()}


def test_no_port_module_names_a_path_of_the_jax_package():
    """No string in the port's code (docstrings and `file.py:line`
    citations of the TPU kernels aside) names the JAX package's directory,
    so nothing is built or loaded from there."""
    citation = re.compile(r"banjax_tpu/[\w/]+\.py:\d+")
    bad = []
    for path in sorted((ROOT / "banjax_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        docs = {
            id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef, ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)
        }
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs
                    and ("banjax_tpu/" in citation.sub("", node.value)
                         or node.value == "banjax_tpu")):
                bad.append((str(path.relative_to(ROOT)), node.value))
    assert not bad, bad
