"""Sharding-invariance: output must be bit-identical under any mesh shape.

This is the distributed-correctness analog of the reference's determinism
(SURVEY.md section 5): frames over the 'data' axis, 16-line block rows over
the 'tile' axis, zero halo -- so every mesh shape must reproduce the
single-device engine exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from versatilefilmgrain_tpu.models import config as cfgmod
from versatilefilmgrain_tpu.models import fw
from versatilefilmgrain_tpu.models.hw import HwRegs
from versatilefilmgrain_tpu.ops import lfsr
from versatilefilmgrain_tpu.ops.grain_jnp import add_grain_frame_jit
from versatilefilmgrain_tpu.parallel import mesh as pmesh

H, W, F = 128, 256, 4
R, C = H // 16, W // 16


def _setup(csub=(2, 2)):
    regs = HwRegs()
    regs.set_depth(10)
    regs.set_chroma_subsampling(*csub)
    sei = cfgmod.default_sei()
    if csub == (1, 1):
        # 4:4:4 requires luma-only grain (pipeline.check_cfg_sei).
        sei.comp_model_present_flag = [1, 0, 0]
    fw.init_sei(sei, regs)
    rng = np.random.default_rng(7)
    sx, sy = csub
    y = rng.integers(0, 1024, (F, H, W)).astype(np.int32)
    u = rng.integers(0, 1024, (F, H // sy, W // sx)).astype(np.int32)
    v = rng.integers(0, 1024, (F, H // sy, W // sx)).astype(np.int32)
    bases, bases_up = [], []
    for f in range(F):
        e0 = lfsr.frame_base_exponent(f, R, C)
        bases.append(int(lfsr.advance(np.uint32(regs.seed_state), e0)))
        bases_up.append(int(lfsr.advance(np.uint32(regs.seed_state),
                                         e0 - C)) if e0 else bases[-1])
    return regs, y, u, v, np.array(bases, np.uint32), np.array(bases_up, np.uint32)


def _reference_frames(regs, y, u, v, bases, bases_up, csub=(2, 2)):
    dp = regs.device_params()
    outs = []
    for f in range(F):
        o = add_grain_frame_jit(
            jnp.asarray(y[f]), jnp.asarray(u[f]), jnp.asarray(v[f]),
            jnp.uint32(bases[f]), jnp.uint32(bases_up[f]),
            jnp.asarray(dp["pattern"]), jnp.asarray(dp["sluts"]),
            jnp.asarray(dp["pluts"]), dp["scale_shift"],
            dp["y_min"], dp["y_max"], dp["c_min"], dp["c_max"],
            height=H, width=W, bs=2, csubx=csub[0], csuby=csub[1])
        outs.append(tuple(np.asarray(p) for p in o))
    return outs


@pytest.mark.parametrize("csub", [(2, 2), (1, 1)],
                         ids=["420", "444_lumaonly"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 8), (2, 4), (4, 2), (2, 2),
                                   (4, 1)])
def test_mesh_invariance(shape, csub):
    nd, nt = shape
    if len(jax.devices()) < nd * nt:
        pytest.skip("not enough devices")
    regs, y, u, v, bases, bases_up = _setup(csub)
    ref = _reference_frames(regs, y, u, v, bases, bases_up, csub)

    m = pmesh.make_mesh(nd, nt)
    step = pmesh.make_grain_step(m, bs=2, csubx=csub[0], csuby=csub[1])
    from versatilefilmgrain_tpu.ops.grain_fast import fast_args, fast_tables
    ft = fast_tables(regs)
    yo, uo, vo = step(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                      jnp.asarray(bases), jnp.asarray(bases_up),
                      *fast_args(ft))
    for f in range(F):
        assert np.array_equal(np.asarray(yo)[f], ref[f][0]), f"Y frame {f}"
        assert np.array_equal(np.asarray(uo)[f], ref[f][1]), f"U frame {f}"
        assert np.array_equal(np.asarray(vo)[f], ref[f][2]), f"V frame {f}"


@pytest.mark.parametrize("csub", [(2, 2), (1, 1)],
                         ids=["420", "444_lumaonly"])
@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 1)])
def test_mesh_invariance_triton(shape, csub):
    """The fused Triton kernel (the GPU engine; interpret mode here) under
    shard_map: every mesh shape reproduces the single-device reference
    engine bit for bit, including tile shards whose first block row blends
    from the up-state lattice."""
    nd, nt = shape
    if len(jax.devices()) < nd * nt:
        pytest.skip("not enough devices")
    regs, y, u, v, bases, bases_up = _setup(csub)
    ref = _reference_frames(regs, y, u, v, bases, bases_up, csub)

    from versatilefilmgrain_tpu.ops.grain_triton import (table_args,
                                                         triton_tables)
    m = pmesh.make_mesh(nd, nt)
    step = pmesh.make_grain_step(m, bs=2, csubx=csub[0], csuby=csub[1],
                                 engine="triton", interpret=True)
    yo, uo, vo = step(jnp.asarray(y.astype(np.uint16)),
                      jnp.asarray(u.astype(np.uint16)),
                      jnp.asarray(v.astype(np.uint16)),
                      jnp.asarray(bases), jnp.asarray(bases_up),
                      *table_args(triton_tables(regs)))
    for f in range(F):
        assert np.array_equal(np.asarray(yo)[f], ref[f][0]), f"Y frame {f}"
        assert np.array_equal(np.asarray(uo)[f], ref[f][1]), f"U frame {f}"
        assert np.array_equal(np.asarray(vo)[f], ref[f][2]), f"V frame {f}"
