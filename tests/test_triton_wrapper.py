"""What surrounds the fused Triton kernel, checked on the CPU: column-tile
masks at widths that are not a multiple of the tile, a zero-scale plane,
the lowering to Triton IR, the engine choice, the compile-cache placement
and chip_smoke.py's refusal to run without a GPU."""

import functools
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from versatilefilmgrain_tpu.ops import grain_triton
from versatilefilmgrain_tpu.ops.grain_jnp import add_grain_frame_jit
from versatilefilmgrain_tpu.ops.grain_triton import (add_grain_batch,
                                                     table_args,
                                                     triton_tables)
from versatilefilmgrain_tpu.utils import compile_cache
from versatilefilmgrain_tpu.utils.parsers import ConfigError

from test_fast_engine import _regs_for
from test_triton_engine import _bases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = {"420": (2, 2), "422": (2, 1), "444": (1, 1)}


def _padded_planes(rng, w, h, depth, csub):
    """Planes of a w x h frame edge-padded to whole blocks, as the pipeline
    hands them to an engine."""
    from versatilefilmgrain_tpu.utils import yuv
    sx, sy = csub
    R, C = -(-h // 16), -(-w // 16)
    dt = np.uint8 if depth == 8 else np.uint16
    hi = 1 << depth
    y = rng.integers(0, hi, (h, w)).astype(dt)
    u = rng.integers(0, hi, (h // sy, w // sx)).astype(dt)
    v = rng.integers(0, hi, (h // sy, w // sx)).astype(dt)
    return (yuv.pad_plane(y, R * 16, C * 16),
            yuv.pad_plane(u, R * 16 // sy, C * 16 // sx),
            yuv.pad_plane(v, R * 16 // sy, C * 16 // sx))


def _check_vs_reference(regs, planes, w, h, frames=(0, 1)):
    """Kernel (interpret mode) == grain_jnp on every padded sample."""
    R, C = planes[0].shape[0] // 16, planes[0].shape[1] // 16
    bases, bases_up = _bases(regs, frames, R, C)
    n = len(frames)
    out = add_grain_batch(
        *(jnp.asarray(np.stack([p] * n)) for p in planes),
        jnp.asarray(np.array(bases, np.uint32)),
        jnp.asarray(np.array(bases_up, np.uint32)),
        *table_args(triton_tables(regs)), bs=regs.bs, csubx=regs.csubx,
        csuby=regs.csuby, interpret=True)
    dp = regs.device_params()
    for fi in range(n):
        ref = add_grain_frame_jit(
            *(jnp.asarray(p) for p in planes), jnp.uint32(bases[fi]),
            jnp.uint32(bases_up[fi]), jnp.asarray(dp["pattern"]),
            jnp.asarray(dp["sluts"]), jnp.asarray(dp["pluts"]),
            dp["scale_shift"], dp["y_min"], dp["y_max"], dp["c_min"],
            dp["c_max"], height=h, width=w, bs=regs.bs, csubx=regs.csubx,
            csuby=regs.csuby)
        for p in range(3):
            assert np.array_equal(np.asarray(ref[p]),
                                  np.asarray(out[p])[fi]), \
                f"{w}x{h} frame {frames[fi]} plane {p}"
    return out


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("width", [193, 194, 195, 400])
def test_column_tiles_and_masks(width, fmt):
    """Widths whose block count is not a multiple of NB (the last tile is
    partly masked; 400 spans two tiles), including the pad-leak widths
    193-195, where a deblock reads the padding column."""
    csub = FORMATS[fmt]
    regs = _regs_for("sei_ff" if fmt == "420" else "sei_ar", 10, csub)
    rng = np.random.default_rng(width)
    planes = _padded_planes(rng, width, 48, 10, csub)
    assert (planes[0].shape[1] // 16) % grain_triton.NB
    _check_vs_reference(regs, planes, width, 48)


def test_zero_scale_planes():
    """Luma-only grain leaves both chroma scale LUTs zero: those planes come
    out as clip(x), and luma still matches the reference."""
    regs = _regs_for("sei_ar", 8, (2, 2))
    assert not regs.slut[1:].any() and regs.slut[0].any()
    rng = np.random.default_rng(5)
    planes = _padded_planes(rng, 256, 64, 8, (2, 2))
    out = _check_vs_reference(regs, planes, 256, 64, frames=(0,))
    for p in (1, 2):
        want = np.clip(planes[p], regs.c_min, regs.c_max)
        assert np.array_equal(np.asarray(out[p])[0], want)


@pytest.mark.parametrize("depth,csub", [(10, (2, 2)), (8, (2, 2)),
                                        (10, (2, 1)), (8, (1, 1))])
def test_kernel_lowers_to_triton(depth, csub):
    """The kernel lowers to Triton IR for CUDA (every primitive has a
    Triton lowering); only the GPU compiler can be asked beyond that."""
    F, H, W = 2, 64, 512
    sx, sy = csub
    dt = jnp.uint8 if depth == 8 else jnp.uint16
    sds = jax.ShapeDtypeStruct
    regs = _regs_for("sei_ff" if csub == (2, 2) else "sei_ar", depth, csub)
    args = ((sds((F, H, W), dt),) + (sds((F, H // sy, W // sx), dt),) * 2
            + (sds((F,), jnp.uint32),) * 2
            + tuple(sds(a.shape, a.dtype)
                    for a in table_args(triton_tables(regs))))
    fn = jax.jit(functools.partial(add_grain_batch, bs=depth - 8, csubx=sx,
                                   csuby=sy))
    exp = jax.export.export(
        fn, platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args)
    assert exp.mlir_module().count("__gpu$xla.gpu.triton") == 1


@pytest.mark.parametrize("backend,engine", [("cpu", "fast"),
                                            ("gpu", "triton")])
def test_auto_engine_choice(monkeypatch, backend, engine):
    from versatilefilmgrain_tpu.pipeline import GrainPipeline
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert GrainPipeline(256, 192, 10, 0, engine="auto").engine == engine


@pytest.mark.parametrize("entry", ["pipeline", "cli", "mesh", "step"])
def test_triton_by_name_needs_gpu(entry, tmp_path, capsys):
    """Asking for the kernel by name off a GPU is an error, not a silent
    interpret-mode fallback."""
    from versatilefilmgrain_tpu.cli import main
    from versatilefilmgrain_tpu.parallel import mesh as pmesh
    from versatilefilmgrain_tpu.pipeline import GrainPipeline

    if entry == "cli":
        rc = main(["vfgs", "-w", "256", "-h", "192", "--engine", "triton",
                   str(tmp_path / "in.yuv"), str(tmp_path / "out.yuv")])
        assert rc == 1
        assert "needs a GPU backend" in capsys.readouterr().err
        return
    with pytest.raises(ConfigError, match="needs a GPU backend"):
        if entry == "pipeline":
            GrainPipeline(256, 192, 10, 0, engine="triton")
        elif entry == "mesh":
            pmesh.make_grain_step(pmesh.make_mesh(1, 1), bs=2, csubx=2,
                                  csuby=2, engine="triton")
        else:
            grain_triton.make_batched_step(bs=2, csubx=2, csuby=2)


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", None)
            assert compile_cache.setup_compile_cache() == str(tmp_path)
            # JAX reads the variable itself; nothing is set in code.
            assert jax.config.jax_compilation_cache_dir is None
        else:
            monkeypatch.delenv(compile_cache.ENV, raising=False)
            want = os.path.join(REPO, ".jax_cache")
            assert compile_cache.setup_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """No GPU, or no repository beside the script: nonzero exit and no
    result line."""
    if where == "checkout":
        cwd, script = REPO, os.path.join(REPO, "chip_smoke.py")
        reason = "not a GPU"
    else:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        cwd = str(tmp_path)
        reason = "checkout"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert reason in r.stderr
    assert '"ok"' not in r.stdout


def test_tables_do_not_alias_the_register_file():
    """A config switch rewrites the register file while the previous batch
    may still be reading its tables (a CPU array can be zero-copy)."""
    regs = _regs_for("sei_ff", 10, (2, 2))
    t = triton_tables(regs)
    for k in grain_triton.TABLE_KEYS:
        for reg in (regs.pattern, regs.slut, regs.plut):
            assert not np.shares_memory(t[k], reg), k
