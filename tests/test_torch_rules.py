"""Rules of the port: it imports neither JAX nor the reference package, its
entry points run on the card unless the caller asks for the CPU, and a
kernel backend never falls back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.kernels import ops

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_import_leaves_jax_out():
    mods = ["repro_torch", "repro_torch.convert", "repro_torch.core.band",
            "repro_torch.core.householder", "repro_torch.core.tuning",
            "repro_torch.core.bulge_chasing", "repro_torch.core.bidiag_svd",
            "repro_torch.core.svd", "repro_torch.core.stage1",
            "repro_torch.core.transforms", "repro_torch.kernels.ops",
            "repro_torch.kernels.ref", "repro_torch.kernels.bulge_chase",
            "repro_torch.kernels.bisect", "repro_torch.kernels.hh_apply",
            "repro_torch.kernels.fused_small", "repro_torch.kernels._build",
            "repro_torch.kernels.flash_attention", "repro_torch.configs",
            "repro_torch.configs.base", "repro_torch.configs.phi3_medium_14b",
            "repro_torch.configs.llama3_8b", "repro_torch.configs.granite_3_2b",
            "repro_torch.configs.codeqwen15_7b",
            "repro_torch.configs.pixtral_12b", "repro_torch.models",
            "repro_torch.models.modules", "repro_torch.models.attention",
            "repro_torch.models.transformer", "repro_torch.models.zoo",
            "repro_torch.serve", "repro_torch.serve.engine",
            "repro_torch.launch", "repro_torch.launch.serve",
            "repro_torch.core.bidiag_dc", "repro_torch.kernels.dc",
            "repro_torch.autotune", "repro_torch.autotune.model",
            "repro_torch.autotune.measure", "repro_torch.autotune.cache",
            "repro_torch.autotune.search", "repro_torch.autotune.__main__",
            "repro_torch.obs", "repro_torch.obs.trace",
            "repro_torch.obs.hist", "repro_torch.obs.export",
            "repro_torch.obs.prom", "repro_torch.serve.metrics",
            "repro_torch.serve.faults", "repro_torch.serve.async_engine",
            "repro_torch.serve.wire", "repro_torch.serve.worker",
            "repro_torch.serve.router", "repro_torch.core.distributed",
            "repro_torch.launch.mesh", "repro_torch.models.moe",
            "repro_torch.models.ssm", "repro_torch.models.rwkv",
            "repro_torch.models.encdec",
            "repro_torch.configs.deepseek_moe_16b",
            "repro_torch.configs.granite_moe_3b_a800m",
            "repro_torch.configs.hymba_1_5b",
            "repro_torch.configs.rwkv6_1_6b",
            "repro_torch.configs.whisper_medium",
            "repro_torch.configs.shapes", "repro_torch.train",
            "repro_torch.train.tree", "repro_torch.train.optimizer",
            "repro_torch.train.data", "repro_torch.train.checkpoint",
            "repro_torch.train.ft", "repro_torch.train.spectral",
            "repro_torch.train.trainer", "repro_torch.launch.train"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_point_defaults_to_the_card():
    a = np.triu(np.random.default_rng(0).standard_normal((12, 12)))
    a = a - np.triu(a, 4)
    if torch.cuda.is_available():
        assert repro_torch.banded_singular_values(a, bw=3).device.type == \
            "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.banded_singular_values(a, bw=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.bidiagonal_of(a, bw=3)
    assert repro_torch.PipelineConfig.resolve(bw=3).device == "cuda"
    assert repro_torch.PipelineConfig.resolve(bw=3).backend == "cuda"
    sig = repro_torch.banded_singular_values(a, bw=3, device="cpu")
    assert sig.device.type == "cpu"


def test_model_and_engine_default_to_the_card():
    from repro_torch.configs import smoke_of
    from repro_torch.launch import serve
    from repro_torch.models import Model, build
    cfg = smoke_of("phi3-medium-14b")
    if torch.cuda.is_available():
        assert build(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "phi3-medium-14b", "--requests", "1"])
    assert build(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "rwkv6-1.6b",
                                  "whisper-medium"])
def test_every_family_defaults_to_the_card(arch):
    """``build`` of each family's full config, and the launcher, default to
    the card: without one they raise, naming ``device="cpu"``."""
    from repro_torch.configs import get_config, smoke_of
    from repro_torch.launch import serve
    from repro_torch.models import build
    if torch.cuda.is_available():
        assert build(smoke_of(arch)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(get_config(arch))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", arch, "--requests", "1"])
    assert build(smoke_of(arch), device="cpu").device.type == "cpu"


def test_cuda_backend_on_cpu_tensor_raises():
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ops.sturm_bisect(torch.zeros(1, 3, dtype=torch.float64),
                         torch.ones(1, dtype=torch.float64), n=2,
                         max_iter=4, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        repro_torch.PipelineConfig.resolve(bw=4, backend="cuda",
                                           device="cpu")
    assert ops.resolve_backend("auto", "cpu") == "ref"
    assert ops.resolve_backend("auto", "cuda") == "cuda"


def test_dc_kernels_refuse_cpu_tensors_and_autotune_defaults_to_the_card():
    from repro_torch.autotune.__main__ import main as autotune_main
    from repro_torch.kernels import dc
    x = torch.zeros(2, 4, dtype=torch.float64)
    flags = torch.zeros(2, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        ops.dc_deflate(x, x, x, x, flags, torch.ones(2, dtype=torch.float64),
                       backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        dc.dc_leaf_cuda(x, x[:, :3], x[:, 0], x[:, 0], x[:, 0],
                        torch.zeros(4, 4, dtype=torch.float64),
                        bisect_iters=1, inv_iters=1)
    with pytest.raises(ValueError, match="CUDA"):
        dc.dc_secular_cuda(x, x, x, flags, x, flags,
                           torch.zeros(2, 1, dtype=torch.int64), nact=1,
                           newton_iters=1)
    assert sum(dc.launches.values()) == 0
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune_main(["--shapes", "n=16:bw=4", "--no-store"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.PipelineConfig.resolve(bw=4, n=16, autotune=True)


def test_training_defaults_to_the_card():
    """``launch.train`` and a Trainer of a default-built model run on the
    card: without one they raise, naming ``device="cpu"``."""
    from repro_torch.configs import smoke_of
    from repro_torch.launch import train
    from repro_torch.models import build
    from repro_torch.train import AdamWConfig, Trainer
    if torch.cuda.is_available():
        tr = Trainer(build(smoke_of("granite-3-2b")), AdamWConfig())
        state = tr.init_state(torch.Generator("cuda").manual_seed(0))
        assert state["params"]["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "granite-3-2b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(build(smoke_of("granite-3-2b")), AdamWConfig())


def test_flash_backward_on_a_cuda_tensor_launches_or_raises():
    """``backend="cuda"`` for the backward takes CUDA tensors only, and the
    kernel's wrapper refuses CPU tensors; nothing falls back."""
    from repro_torch.kernels import flash_attention
    q = torch.zeros(2, 8, 16)
    k = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_bwd(q, k, k, q, q, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_bwd_cuda(q, k, k, q, q)
    leaves = [x.clone().requires_grad_() for x in (q, k, k)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(*leaves, backend="cuda")
    assert flash_attention.launches["flash_attention_bwd"] == 0 or \
        torch.cuda.is_available()
    if torch.cuda.is_available():
        before = ops.launch_counts()["flash_attention_bwd"]
        dev = [x.detach().cuda().requires_grad_() for x in (q, k, k)]
        ops.flash_attention(*dev).sum().backward()
        assert ops.launch_counts()["flash_attention_bwd"] == before + 1
