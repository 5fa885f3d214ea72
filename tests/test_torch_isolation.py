"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or ``repro``, and entry points called
without a device ask for CUDA and raise where it is absent; the card check
builds every kernel source."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
                and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = {n for n in _imported(path)
           if n.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_checked_files_cover_every_kernel_and_model_module():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES
             if "repro_torch" in p.parts}
    assert {"models/recurrent.py", "models/transformer.py", "kernels/rglru.py",
            "kernels/flash_attention.py", "kernels/rmsnorm.py", "kernels/ops.py",
            "kernels/_build.py", "train/step.py", "comms/hierarchical.py",
            "comms/schedule_bridge.py", "core/scheduler.py",
            "ckpt/checkpoint.py", "launch/roofline.py", "core/simulator.py",
            "core/engine_compiled.py", "core/invariants.py", "core/consistency.py",
            "core/insights.py", "core/workloads.py", "core/batch.py",
            "obs/tracer.py", "obs/timeline.py", "topology/search.py",
            "faults/schedule.py", "faults/replan.py", "traffic/ir.py", "traffic/engine.py",
            "traffic/builders.py", "tenancy/tenants.py", "tenancy/arbiter.py",
            "tenancy/elastic.py", "tenancy/metrics.py", "tenancy/fabric.py"} <= names


def test_chip_smoke_builds_every_kernel_source():
    """``chip_smoke.py``'s build phase names every ``csrc/*.cu`` (the K1
    forward and backward kernels of both routes and K3), so each is built
    and its ptxas and SASS counts reported on the card."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "phase_kernels")
    built = next(ast.literal_eval(n.value) for n in ast.walk(fn)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "sources")
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert sorted(built) == sorted(p.stem for p in csrc.glob("*.cu"))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve, train
    from repro_torch.models import build_model
    from repro_torch.train.serve import make_serve_fns

    api = build_model(get_arch("llama3-8b", reduced=True))
    for call in (resolve_device,
                 lambda: api.init(0),
                 lambda: make_serve_fns(api),
                 lambda: bridge.params_from_jax({}),
                 lambda: serve.setup("llama3-8b", reduced=True),
                 lambda: serve.main(["--reduced"]),
                 lambda: train.main(["--reduced"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
