"""Package rules of the port: it imports neither JAX nor `repro`, and its
entry points build on CUDA unless the caller asks for the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as rt
from repro_torch import interop
from repro_torch.core.types import SYS_ARRAYS, SYS_SCALARS

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.interop, "
            "repro_torch.core.baselines, repro_torch.kernels.ops, "
            "repro_torch.kernels.build, repro_torch.configs, "
            "repro_torch.models.transformer, repro_torch.launch.serve, "
            "repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.optim, repro_torch.data, repro_torch.checkpoint, "
            "repro_torch.diff, repro_torch.dynamics, repro_torch.region, "
            "repro_torch.core.costmodel, repro_torch.launch.specs, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.launch.fedavg_lm, repro_torch.roofline, "
            "repro_torch.sharding; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton', 'msgpack')); "
            "print(bad); "
            "sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def leaves(n=8):
    d = {k: np.ones(n) for k in SYS_ARRAYS}
    d.update({k: np.float64(1.0) for k in SYS_SCALARS})
    return d


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.make_system(0, n_devices=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.make_fleet(0, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.system_from_numpy(leaves(), (160.0, 640.0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.allocation_from_numpy(
            {k: np.ones(8) for k in ("bandwidth", "power", "freq",
                                     "resolution")})
    from repro_torch.dynamics import (RoundsConfig, draws_from_generator,
                                      mobility_draws, simulate_mobility)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        draws_from_generator(0, 1, 2, 8, RoundsConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_mobility(0, n_devices=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mobility_draws(0, 8, 1, rt.MobilityConfig())
    assert rt.make_system(0, n_devices=8, device="cpu").device.type == "cpu"
    s = interop.system_from_numpy(leaves(), (160.0, 640.0), device="cpu")
    assert s.device.type == "cpu" and s.p_max.shape == ()


def test_interop_reshapes_stacked_scalars():
    d = {k: np.ones((3, 8)) for k in SYS_ARRAYS}
    d.update({k: np.arange(3.0) + 1 for k in SYS_SCALARS})
    d["active"] = np.ones((3, 8), bool)
    s = interop.system_from_numpy(d, (160.0, 640.0), device="cpu",
                                  dtype=torch.float32)
    assert s.cells == 3 and s.p_max.shape == (3, 1)
    assert s.gain.dtype == s.p_max.dtype == torch.float32
    assert s.active.dtype == torch.bool


def test_serve_needs_cuda_unless_asked_for_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "rwkv6-1.6b", "--reduced", "--batch", "1",
            "--prompt-len", "4", "--gen", "2"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(argv)
    assert serve.main(argv + ["--device", "cpu"]).shape == (1, 2)


def test_port_calls_no_library_attention_or_compiler():
    """The port's kernels are its own: no SDPA, cuDNN or torch.compile."""
    banned = ("scaled_dot_product_attention", "torch.compile", "cudnn",
              "flash_attn")
    pkg = SRC / "repro_torch"
    hits = [f"{p.relative_to(pkg)}: {b}"
            for p in sorted(pkg.rglob("*")) if p.suffix in (".py", ".cu")
            for b in banned if b in p.read_text()]
    assert not hits, hits
