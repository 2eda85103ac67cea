"""The port stands alone: h2o_tpu_torch imports neither JAX nor h2o_tpu
(nor pandas, which the card's machine lacks), builds its host libraries
from its own sources, picks the card unless told otherwise, and never
hands a kernel's work to the plain PyTorch version behind the caller's
back."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import h2o_tpu_torch
from h2o_tpu_torch.ops import hist_kernels as hk
from h2o_tpu_torch.ops.histogram import histogram_build

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "h2o_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "h2o_tpu")


def test_importing_every_module_pulls_in_no_jax():
    mods = [m for m, _ in _modules()]
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'h2o_tpu', 'pandas'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.mark.parametrize("path", [p for _, p in _modules()] +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), \
            f"{path.name}:{node.lineno} imports {names}"


def test_host_libraries_build_from_the_port_sources():
    """Both C++ libraries come from the port's own copies, built by g++
    into h2o_tpu_torch/_build/, never from h2o_tpu/native."""
    from h2o_tpu_torch import native
    for name in ("csv_tokenizer", "treeshap"):
        src = PKG / "native" / f"{name}.cpp"
        assert src.is_file()
        built = native.load(name)
        assert built.path == PKG / "_build" / f"lib{name}.so"
        assert built.path.stat().st_mtime >= src.stat().st_mtime
    assert native.BUILD_DIR == PKG / "_build"
    assert native._DIR == PKG / "native"


def test_default_device_is_the_card(monkeypatch):
    from h2o_tpu_torch.models.tree.gbm import GBM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        h2o_tpu_torch.cloud()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GBM()
    with pytest.raises(RuntimeError):
        GBM(device="cuda")
    assert h2o_tpu_torch.cloud("cpu") == torch.device("cpu")
    assert GBM(device="cpu").device == torch.device("cpu")


def test_loaded_models_take_the_card(monkeypatch, tmp_path):
    """A saved model loads onto the card unless the caller names the CPU,
    and a checkpoint given by path loads onto its builder's device."""
    import numpy as np
    from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
    from h2o_tpu_torch.models.model import Model
    from h2o_tpu_torch.models.tree.gbm import GBM
    rng = np.random.default_rng(0)
    x = rng.normal(size=200).astype(np.float32)
    fr = Frame(["x", "y"], [Vec(x), Vec((x > 0).astype(np.int32), T_CAT,
                                        domain=["a", "b"])])
    path = GBM(device="cpu", ntrees=1, max_depth=2).train(
        y="y", training_frame=fr).save(str(tmp_path / "m.bin"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model.load(path)
    assert Model.load(path, device="cpu").device == torch.device("cpu")
    m = GBM(device="cpu", ntrees=2, max_depth=2, checkpoint=path).train(
        y="y", training_frame=fr)
    assert m.device == torch.device("cpu")


def test_kernel_dispatch_never_falls_back():
    bins = torch.zeros((8, 2), dtype=torch.uint8)
    leaf = torch.zeros(8, dtype=torch.int32)
    stats = torch.ones((8, 4))
    # the CUDA wrappers refuse anything but CUDA tensors ...
    with pytest.raises(ValueError, match="CUDA"):
        hk.hist_cuda(bins, leaf, stats, 1, 4)
    lo = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hk.hist_cuda_adaptive(bins, leaf, stats, lo, lo + 3, lo,
                              torch.zeros(2, dtype=torch.bool), 1, 4, 8)
    assert hk.hist_cuda.launches == 0 and hk.hist_cuda_adaptive.launches == 0
    # ... and a device with no kernel raises instead of computing elsewhere
    meta = [t.to("meta") for t in (bins, leaf, stats)]
    with pytest.raises(RuntimeError, match="no kernel"):
        histogram_build(*meta, 1, 4)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(hk, "_LIBRARY", None)
    monkeypatch.setattr(hk, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(hk, "_find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        hk.build()
    assert not (tmp_path / "build").exists()


_BUILDERS = {
    "gbm": ("h2o_tpu_torch.models.tree.gbm", "GBM"),
    "drf": ("h2o_tpu_torch.models.tree.drf", "DRF"),
    "xgboost": ("h2o_tpu_torch.models.tree.xgboost", "XGBoost"),
    "dt": ("h2o_tpu_torch.models.tree.dt", "DT"),
    "isolationforest": ("h2o_tpu_torch.models.tree.isofor",
                        "IsolationForest"),
    "extendedisolationforest": ("h2o_tpu_torch.models.tree.isofor",
                                "ExtendedIsolationForest"),
    "upliftdrf": ("h2o_tpu_torch.models.tree.uplift", "UpliftDRF"),
    "generic": ("h2o_tpu_torch.models.generic", "Generic"),
}


@pytest.mark.parametrize("algo", sorted(_BUILDERS))
def test_every_builder_and_converter_takes_the_card(algo, monkeypatch):
    """No device argument means cuda:0 for every builder and for the
    converter of its models; without CUDA both raise and ask for the
    CPU by name instead of computing there."""
    import importlib
    from h2o_tpu_torch.models.tree import convert
    mod, name = _BUILDERS[algo]
    cls = getattr(importlib.import_module(mod), name)
    assert cls(device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls()
    if algo == "generic":
        # a Generic model's "converter" is from_mojo, behind import_mojo
        from h2o_tpu_torch.models.generic import GenericModel
        from h2o_tpu_torch.mojo import MojoModel

        def conv(out, params):
            return GenericModel.from_mojo(MojoModel("gbm", params, out, {}))
    else:
        conv = getattr(convert, f"{algo}_from_jax_output")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        conv({}, {})


def test_mojo_generic_and_engine_take_the_card(monkeypatch, tmp_path):
    """import_mojo lands on the card unless told otherwise; the engine
    keeps no device of its own and scores on its model's."""
    import numpy as np
    from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
    from h2o_tpu_torch.models.tree.gbm import GBM
    from h2o_tpu_torch.mojo import export_mojo, import_mojo
    from h2o_tpu_torch.serve import ScoringEngine
    rng = np.random.default_rng(0)
    x = rng.normal(size=200).astype(np.float32)
    fr = Frame(["x", "y"], [Vec(x), Vec((x > 0).astype(np.int32), T_CAT,
                                        domain=["a", "b"])])
    m = GBM(device="cpu", ntrees=1, max_depth=2).train(y="y",
                                                       training_frame=fr)
    path = export_mojo(m, str(tmp_path / "m.zip"))
    assert import_mojo(path, device="cpu").device == torch.device("cpu")
    seen = []

    class _OnMeta:
        algo, model_id, params = "gbm", "meta_model", m.params
        output, device = m.output, torch.device("meta")

        def predict_raw_array(self, X):
            seen.append(X.device)
            return torch.zeros((X.shape[0], 3))

    monkeypatch.setattr(ScoringEngine, "has_device_predict",
                        staticmethod(lambda model: True))
    ScoringEngine().predict(_OnMeta(), 0, np.zeros((3, 1)))
    assert seen == [torch.device("meta")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        import_mojo(path)
