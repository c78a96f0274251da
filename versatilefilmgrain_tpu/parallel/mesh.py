"""Device-mesh sharding for the grain engine.

The reference is strictly serial (SURVEY.md section 2.6: no threads, SIMD, or
distributed backend).  This build parallelizes on two mesh axes:

* ``data``  -- frames.  Grain state at any frame is closed-form in the frame
  index (ops/lfsr.py), so frames are embarrassingly parallel.
* ``tile``  -- 16-luma-line block rows within a frame.  Vertical overlap
  blends *pattern samples* selected by the ``rnd_up`` lattice, never
  neighbouring pixels, so row tiles need zero halo exchange.

Output is bit-identical under any mesh shape (test_sharding.py proves it on a
virtual 8-device CPU mesh); the steady-state kernel needs no collectives --
XLA only reshards the small state lattices (KBs) at the shard_map boundary.

The mesh follows the algorithm alone: the GPUs of one host are joined all to
all by NVLink, so any (data, tile) factoring of them is equally close.
Across hosts, initialize ``jax.distributed`` and build the mesh over
``jax.devices()``.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import lfsr
from ..ops.grain_fast import plane_grain_fast
from ..ops.grain_jnp import plane_grain


def make_mesh(n_data: int, n_tile: int, devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = n_data * n_tile
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    return Mesh(np.array(devices[:n]).reshape(n_data, n_tile),
                ("data", "tile"))


def default_mesh_shape(n_devices: int, rows: int) -> tuple[int, int]:
    """Pick (data, tile) factors.

    Frames (data) are embarrassingly parallel so they get the larger share;
    tile only takes what divides the block-row count, keeping the mesh 2-D
    when possible (tile sharding is what cuts single-frame latency)."""
    best = (n_devices, 1)
    for t in range(2, min(n_devices, rows) + 1):
        if n_devices % t == 0 and rows % t == 0 and t <= n_devices // t:
            best = (n_devices // t, t)
    return best


def make_grain_step(mesh: Mesh, *, bs: int, csubx: int, csuby: int,
                    engine: str = "fast", interpret: bool = False):
    """Build a jitted multi-device grain step over ``mesh``.

    Returned fn signature (fast engine, the default):
        step(y, u, v, bases, bases_up, win_luma, win_luma_up, win_chroma,
             win_chroma_up, seg_starts, seg_deltas, scale_shift, y_min,
             y_max, c_min, c_max) -> (y, u, v)
    with y: (F, R*16, C*16) padded planes (F divisible by mesh 'data' size,
    R divisible by mesh 'tile' size), bases/bases_up: (F,) uint32 per-frame
    lattice bases.  R may exceed ceil(height/16) so that it divides the tile
    axis: the lattice of the real rows does not depend on R, and the extra
    rows are cropped by the caller like any padding.
    With engine="ref", the table args are (pattern, sluts, pluts) and the
    five scalars.  With engine="triton" they are
    ``grain_triton.table_args(triton_tables(regs))``: each shard runs the
    fused GPU kernel (``interpret=True`` runs it on the CPU, for tests).
    """
    plane_spec = P("data", "tile", None)
    state_spec = P("data", "tile", None)
    rep = P()

    if engine == "triton":
        from ..ops import grain_triton
        if not interpret:
            grain_triton.require_gpu()
        _step = functools.partial(grain_triton.grain_planes, bs=bs,
                                  csubx=csubx, csuby=csuby,
                                  interpret=interpret)
        n_rep = len(grain_triton.TABLE_KEYS)
    elif engine == "fast":
        def _step(y, u, v, states, states_up, ov_mask, win_luma, win_luma_up,
                  win_chroma, win_chroma_up, seg_starts, seg_deltas,
                  scale_shift, y_min, y_max, c_min, c_max):
            def one(c, plane, imin, imax):
                fn = functools.partial(
                    plane_grain_fast, c=c, csubx=csubx, csuby=csuby, bs=bs)
                return jax.vmap(
                    lambda p, s, su: fn(p, s, su,
                                        win_luma if c == 0 else win_chroma,
                                        win_luma_up if c == 0 else win_chroma_up,
                                        seg_starts[c], seg_deltas[c],
                                        scale_shift, imin, imax,
                                        ov_mask))(plane, states, states_up)

            return (one(0, y, y_min, y_max), one(1, u, c_min, c_max),
                    one(2, v, c_min, c_max))
        n_rep = 6 + 5
    else:
        def _step(y, u, v, states, states_up, ov_mask, pattern, sluts, pluts,
                  scale_shift, y_min, y_max, c_min, c_max):
            pat = pattern.reshape(2, 512 * 64)

            def one(c, plane, imin, imax):
                fn = functools.partial(
                    plane_grain, c=c, csubx=csubx, csuby=csuby, bs=bs)
                return jax.vmap(
                    lambda p, s, su: fn(p, s, su, pat[1 if c else 0],
                                        sluts[c], pluts[c], scale_shift,
                                        imin, imax,
                                        ov_mask))(plane, states, states_up)

            return (one(0, y, y_min, y_max), one(1, u, c_min, c_max),
                    one(2, v, c_min, c_max))
        n_rep = 3 + 5

    # pallas_call outputs carry no varying-mesh-axes annotation, so the
    # check is off for every engine alike.
    sharded = jax.shard_map(
        _step, mesh=mesh,
        in_specs=(plane_spec, plane_spec, plane_spec, state_spec, state_spec,
                  P("tile")) + (rep,) * n_rep,
        out_specs=(plane_spec, plane_spec, plane_spec), check_vma=False)

    @jax.jit
    def run(y, u, v, bases, bases_up, *tables_and_scalars):
        R, C = y.shape[1] // 16, y.shape[2] // 16
        states = jax.vmap(
            lambda b: lfsr.state_lattice_jax(b, R, C))(bases)
        row0 = jax.vmap(lambda b: lfsr.state_lattice_jax(b, 1, C))(bases_up)
        states_up = jnp.concatenate([row0, states[:, :-1]], axis=1)
        ov = np.zeros(R, dtype=bool)
        ov[1:] = True
        return sharded(y, u, v, states, states_up, jnp.asarray(ov),
                       *tables_and_scalars)

    return run
