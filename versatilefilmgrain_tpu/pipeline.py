"""Outer layer: validation, chroma-format adjustment, gain, POC-scheduled
multi-config switching, and the frame loop (reference: src/vfgs_main.c).

The per-frame LFSR bases are derived in closed form from (frame - epoch) where
``epoch`` is the frame index of the last reseed (AFGS1 inits reseed,
vfgs_fw.c:672; SEI inits do not, so grain state carries across SEI config
switches exactly like the C statics, vfgs_main.c:771-781).
"""

from __future__ import annotations

import numpy as np

from .models import config as cfgmod
from .models import fw
from .models.hw import HwRegs
from .ops import lfsr
from .utils import parsers, yuv
from .utils.parsers import ConfigError, _check

MAX_CONFIGS = 64
# "fast" (XLA) and "triton" (fused GPU kernel) run batched; "ref" is the
# plain per-pixel engine (ops/grain_jnp.py), one frame at a time.
ENGINES = ("auto", "fast", "triton", "ref")


class FatalConfigError(ConfigError):
    """Init-time register errors: the reference aborts here (assert,
    vfgs_hw.c:348); we terminate the run with an error instead of silently
    continuing on the previous config."""


def adjust_chroma_cfg(sei, fmt: int) -> None:
    """Chroma model-value conversion for 4:2:2/4:2:0 (vfgs_main.c:208-230).

    Mutates in place; applied on every config pop, so values re-read from a
    config file get adjusted once but inherited values get re-adjusted (this
    matches the reference, whose statics persist across pops)."""
    if sei.model_id == 0:
        for c in (1, 2):
            if sei.comp_model_present_flag[c]:
                for k in range(sei.num_intensity_intervals[c]):
                    v = sei.comp_model_value[c][k]
                    if fmt < yuv.YUV_444:
                        v[1] = max(2, min(14, int(v[1]) << 1))
                    if fmt < yuv.YUV_422:
                        v[2] = max(2, min(14, int(v[2]) << 1))
                    if fmt == yuv.YUV_420:
                        v[0] = int(v[0]) >> 1
                    elif fmt == yuv.YUV_422:
                        v[0] = (int(v[0]) * 181 + 128) >> 8


def check_cfg_sei(sei, fmt: int, depth: int) -> None:
    """vfgs_main.c:232-267, including the index typo in the vertical-cutoff
    check (the lower bound is tested on value[1], vfgs_main.c:254)."""
    _check(fmt == yuv.YUV_420 or (not sei.comp_model_present_flag[1]
                                  and not sei.comp_model_present_flag[2]),
           "color grain currently not supported on yuv422 and yuv444 formats")
    _check(sei.model_id == 0 or (not sei.comp_model_present_flag[1]
                                 and not sei.comp_model_present_flag[2]),
           "color grain currently not supported in SEI.AR mode")
    _check(sei.model_id <= 1, "SEIFGCModelId shall be 0 or 1")
    rng = 1 << depth
    for c in range(3):
        if sei.comp_model_present_flag[c]:
            _check(1 <= sei.num_model_values[c] <= 6,
                   f"SEIFGCNumModelValuesMinus1Comp{c} out of 0..5 range")
            for i in range(sei.num_intensity_intervals[c]):
                v = sei.comp_model_value[c][i]
                _check(sei.intensity_interval_lower_bound[c][i]
                       <= sei.intensity_interval_upper_bound[c][i],
                       f"inconsistent interval {i} for component {c}")
                _check(v[0] < rng,
                       f"scaling factor for component {c} and interval {i} is too large")
                if sei.model_id == 0:
                    _check(2 <= v[1] <= 14,
                           f"horizontal cutoff frequency for component {c} and "
                           f"interval {i} out of 2..14 range")
                    _check(v[1] >= 2 and v[2] <= 14,
                           f"vertical cutoff frequency for component {c} and "
                           f"interval {i} out of 2..14 range")
                else:
                    for mv in (1, 3, 5):
                        _check(-rng // 2 <= v[mv] < rng // 2,
                               f"AR coefficient for component {c} and interval "
                               f"{i} is out of range")


def check_cfg_afgs1(afgs1, fmt: int) -> None:
    """vfgs_main.c:269-298."""
    _check(fmt == yuv.YUV_420 or (not afgs1.num_cb_points
                                  and not afgs1.num_cr_points),
           "color grain currently not supported on yuv422 and yuv444 formats")
    for name, vals, n in (("y", afgs1.point_y_values, afgs1.num_y_points),
                          ("cb", afgs1.point_cb_values, afgs1.num_cb_points),
                          ("cr", afgs1.point_cr_values, afgs1.num_cr_points)):
        for i in range(1, n):
            _check(vals[i] > vals[i - 1],
                   f"afgs1.point_{name}_values shall be in increasing order")


def check_cfg(sei, afgs1, fmt: int, depth: int) -> None:
    if afgs1.num_y_points:
        check_cfg_afgs1(afgs1, fmt)
    else:
        check_cfg_sei(sei, fmt, depth)


def apply_gain(gain: int, sei, afgs1) -> None:
    """Global grain-strength rescale (vfgs_main.c:561-593). Mutates in place.

    ``gain`` is unsigned in the reference (so a negative CLI value wraps to a
    huge number and the halving loop still terminates), and the scale
    multiplications are unsigned 32-bit; both are replicated here."""
    gain = int(gain) & 0xFFFFFFFF
    if gain == 100:
        return

    def umul_div(v: int) -> int:
        # (int)v * (unsigned)gain / 100 in C: unsigned 32-bit wrap + udiv.
        return ((int(v) * gain) & 0xFFFFFFFF) // 100

    if afgs1.num_y_points:
        while gain > 100:
            afgs1.grain_scaling = (afgs1.grain_scaling - 1) & 0xFF
            gain //= 2
        while gain and gain < 50:
            afgs1.grain_scaling = (afgs1.grain_scaling + 1) & 0xFF
            gain *= 2
        for arr, n in ((afgs1.point_y_scaling, afgs1.num_y_points),
                       (afgs1.point_cb_scaling, afgs1.num_cb_points),
                       (afgs1.point_cr_scaling, afgs1.num_cr_points)):
            for i in range(n):
                arr[i] = np.uint8(umul_div(arr[i]) & 0xFF)
    else:
        while gain > 100:
            sei.log2_scale_factor = (sei.log2_scale_factor - 1) & 0xFF
            gain //= 2
        while gain and gain < 50:
            sei.log2_scale_factor = (sei.log2_scale_factor + 1) & 0xFF
            gain *= 2
        for c in range(3):
            if sei.comp_model_present_flag[c]:
                for i in range(sei.num_intensity_intervals[c]):
                    v = umul_div(sei.comp_model_value[c][i][0])
                    sei.comp_model_value[c][i][0] = np.int16(
                        ((v + 0x8000) & 0xFFFF) - 0x8000)


def parse_cfg_param(param: str):
    """Parse a ``[poc:]filename`` -c argument (vfgs_main.c:595-633)."""
    poc = 0
    filename = param
    idx = param.find(":")
    if idx >= 0:
        head = param[:idx]
        if head and all(parsers._isdig(ch) for ch in head):
            _check(len(head) < 16, "illegal configuration POC")
            poc = int(head)
            filename = param[idx + 1:]
    return poc, filename


class GrainPipeline:
    """Holds persistent metadata/register state and processes frames."""

    def __init__(self, width: int, height: int, depth: int, fmt: int,
                 gain: int = 100, seed: int = 0, seek: int = 0,
                 configs=(), engine: str = "auto", grain_offset: int = 0,
                 initial_sei=None, initial_afgs1=None):
        """``initial_sei``/``initial_afgs1`` replace the built-in default
        config (vfgs_main.c:69-125).  The CLI always starts from the default
        like the reference (which therefore cannot run 4:2:2/4:4:4 at all --
        its chroma-bearing default fails validation); library users can pass
        a luma-only config here to process those formats."""
        if depth not in (8, 10):
            raise ConfigError("input depth must be 8 or 10")
        if width <= 128 or height < 128:
            # The reference hard-asserts width > 128 in the HW hot path
            # (vfgs_hw.c:167-170) and aborts at width == 128; we reject it as
            # a config error instead (tools/fuzz_cfg.py --boundary fuzzes the
            # 130..160 neighbourhood; test_robustness locks this policy).
            raise ConfigError("width must be greater than 128 and height at "
                              "least 128")
        if grain_offset < 0:
            raise ConfigError("grain offset must be non-negative")
        self.width, self.height = width, height
        self.depth, self.fmt = depth, fmt
        self.gain, self.seek = gain, seek
        self.sei = initial_sei if initial_sei is not None else cfgmod.default_sei()
        self.afgs1 = (initial_afgs1 if initial_afgs1 is not None
                      else cfgmod.default_afgs1())
        self.regs = HwRegs()
        self.configs = [parse_cfg_param(p) for p in configs]
        _check(len(self.configs) <= MAX_CONFIGS,
               f"too many configurations (maximum is {MAX_CONFIGS})")
        self.icfg = 0
        self.epoch = 0  # frame index of last reseed
        # Extension beyond the reference: offset the grain-state lattice so a
        # run over frames [grain_offset, ...) is bit-identical to those frames
        # of a full seek-0 run (the reference's -s restarts grain state from
        # the seed, which we replicate when grain_offset == 0).  This is what
        # makes disjoint frame shards concatenate exactly (multi-host data
        # parallelism, stateless crash recovery).
        self.grain_offset = grain_offset
        if engine not in ENGINES:
            raise ConfigError(f"unknown engine {engine!r}")
        if engine == "auto":
            # The fused Triton kernel is the fastest engine on a GPU
            # (docs/DESIGN.md section 3); elsewhere it cannot compile.
            import jax
            engine = "triton" if jax.default_backend() == "gpu" else "fast"
        if engine == "triton":
            from .ops import grain_triton
            grain_triton.require_gpu()
        self.engine = engine
        self._tab_cache = None  # (generation, engine table args)
        self._bsteps = {}       # donate -> jitted batched step
        self._cfg_generation = 0
        self._R = -(-height // 16)
        self._C = -(-width // 16)

        check_cfg(self.sei, self.afgs1, fmt, depth)
        self.regs.set_depth(depth)
        self.regs.set_chroma_subsampling(2 if fmt < yuv.YUV_444 else 1,
                                         2 if fmt < yuv.YUV_422 else 1)
        adjust_chroma_cfg(self.sei, fmt)
        apply_gain(gain, self.sei, self.afgs1)
        self._init_fw(frame=0)
        if seed:
            self.regs.set_seed(seed)

    # ------------------------------------------------------------------

    def _init_fw(self, frame: int) -> None:
        # The reference aborts on an out-of-range scale shift (assert,
        # vfgs_hw.c:348, e.g. --gain driving log2_scale_factor out of [2,8));
        # we fail with a config error instead.
        try:
            if self.afgs1.num_y_points:
                fw.init_afgs1(self.afgs1, self.regs)
                self.epoch = frame  # init_afgs1 reseeds (vfgs_fw.c:672)
            else:
                fw.init_sei(self.sei, self.regs)
        except ValueError as e:
            raise FatalConfigError(str(e))
        self._cfg_generation += 1

    def _tables(self):
        """Config-table arguments of the batched step, rebuilt once per
        config generation."""
        if self._tab_cache is None or self._tab_cache[0] != self._cfg_generation:
            if self.engine == "triton":
                from .ops import grain_triton
                args = grain_triton.table_args(
                    grain_triton.triton_tables(self.regs))
            else:
                from .ops.grain_fast import fast_args, fast_tables
                args = fast_args(fast_tables(self.regs))
            self._tab_cache = (self._cfg_generation, args)
        return self._tab_cache[1]

    def _batched_step(self, donate: bool = False):
        """Jitted ``step(y, u, v, bases, bases_up, *self._tables())`` over a
        leading frame axis, for the fast or triton engine.

        ``donate`` (for fresh device arrays only) lets the XLA engine write
        its outputs into the input planes.  The triton kernel reads one
        pixel column beyond its own tile, so its outputs cannot alias its
        inputs and it never donates."""
        if donate not in self._bsteps:
            regs = self.regs
            if self.engine == "triton":
                from .ops import grain_triton
                step = grain_triton.make_batched_step(
                    bs=regs.bs, csubx=regs.csubx, csuby=regs.csuby)
            else:
                import functools
                import jax
                from .ops.grain_fast import add_grain_frame_fast
                fn = functools.partial(
                    add_grain_frame_fast, height=self.height,
                    width=self.width, bs=regs.bs, csubx=regs.csubx,
                    csuby=regs.csuby)
                step = jax.jit(jax.vmap(fn, in_axes=(0,) * 5 + (None,) * 11),
                               donate_argnums=(0, 1, 2) if donate else ())
            self._bsteps[donate] = step
        return self._bsteps[donate]

    def pop_cfg(self, frame: int) -> None:
        """Re-read/validate/adjust/re-init for the next scheduled config."""
        _check(self.icfg < len(self.configs), "No configuration to pop")
        poc, filename = self.configs[self.icfg]
        parsers.read_cfg(filename, self.sei, self.afgs1)
        check_cfg(self.sei, self.afgs1, self.fmt, self.depth)
        adjust_chroma_cfg(self.sei, self.fmt)
        apply_gain(self.gain, self.sei, self.afgs1)
        self.icfg += 1
        if self.grain_offset:
            # Sharded mode: an AFGS1 reseed epoch is the config's global POC
            # (where the full seek-0 run would have popped it), keeping shard
            # output identical to the full run.
            self._init_fw(poc)
        else:
            self._init_fw(frame)

    def maybe_switch_config(self, n: int) -> None:
        while (self.icfg < len(self.configs)
               and n + self.seek >= self.configs[self.icfg][0]):
            try:
                self.pop_cfg(n)
            except FatalConfigError:
                raise
            except (ConfigError, OSError, ValueError, IndexError,
                    UnicodeDecodeError) as e:
                # The reference keeps processing with the previous config on a
                # failed read/check pop (vfgs_main.c:773-776); malformed
                # inputs that would be undefined behaviour in C (e.g. the
                # dump parser's component counter running past 2) are
                # treated the same way.
                import sys
                print(f"Error: {e}", file=sys.stderr)
                break

    # ------------------------------------------------------------------

    def _has_pad_leak(self) -> bool:
        """True when a deblock at the last interior block boundary reads one
        grain sample beyond the real width (component width == 1 mod block
        width).  The reference then depends on its persistent frame buffer's
        stride padding -- malloc-zeroed at start, accumulating grained values
        across frames (vfgs_hw.c:243-283 writes the full final block;
        yuv_read only overwrites `width` samples per row) -- so those widths
        need the stateful padded-buffer path to stay bit-exact."""
        if self._C < 2:
            return False
        for subx in (1, self.regs.csubx):
            if (self.width // subx) % (16 // subx) == 1:
                return True
        return False

    def frame_bases(self, n: int) -> tuple[int, int]:
        """LFSR lattice bases for frame n (see ops/lfsr.py)."""
        R, C = self._R, self._C
        e0 = lfsr.frame_base_exponent(n + self.grain_offset - self.epoch,
                                      R, C)
        base = int(lfsr.advance(np.uint32(self.regs.seed_state), e0))
        base_up = (int(lfsr.advance(np.uint32(self.regs.seed_state), e0 - C))
                   if e0 > 0 else base)
        return base, base_up

    def process_frame(self, planes, n: int):
        """Add grain to one (Y, U, V) frame (numpy in/out, same dtype)."""
        self.maybe_switch_config(n)
        return self._run_engine(planes, n)

    def _run_engine(self, planes, n: int):
        import jax.numpy as jnp

        regs = self.regs
        R, C = self._R, self._C
        bhc = 16 // regs.csuby
        bwc = 16 // regs.csubx
        y, u, v = planes
        if self._has_pad_leak():
            # Stateful padding: replicate the reference's persistent frame
            # buffer (zeros at start, grained padding carried across frames).
            if getattr(self, "_pbuf", None) is None:
                self._pbuf = [
                    np.zeros((R * 16, C * 16), y.dtype),
                    np.zeros((R * bhc, C * bwc), u.dtype),
                    np.zeros((R * bhc, C * bwc), v.dtype)]
            for buf, p in zip(self._pbuf, (y, u, v)):
                buf[:p.shape[0], :p.shape[1]] = p
            yp, up, vp = self._pbuf
        else:
            yp = yuv.pad_plane(y, R * 16, C * 16)
            up = yuv.pad_plane(u, R * bhc, C * bwc)
            vp = yuv.pad_plane(v, R * bhc, C * bwc)
        base, base_up = self.frame_bases(n)
        if self.engine != "ref":
            yo, uo, vo = self._batched_step()(
                jnp.asarray(yp)[None], jnp.asarray(up)[None],
                jnp.asarray(vp)[None],
                jnp.asarray(np.array([base], np.uint32)),
                jnp.asarray(np.array([base_up], np.uint32)), *self._tables())
            yo, uo, vo = yo[0], uo[0], vo[0]
        else:
            from .ops.grain_jnp import add_grain_frame_jit
            dp = regs.device_params()
            yo, uo, vo = add_grain_frame_jit(
                jnp.asarray(yp), jnp.asarray(up), jnp.asarray(vp),
                jnp.uint32(base), jnp.uint32(base_up),
                jnp.asarray(dp["pattern"]), jnp.asarray(dp["sluts"]),
                jnp.asarray(dp["pluts"]), dp["scale_shift"],
                dp["y_min"], dp["y_max"], dp["c_min"], dp["c_max"],
                height=self.height, width=self.width, bs=regs.bs,
                csubx=regs.csubx, csuby=regs.csuby)
        dt = y.dtype
        cw, ch = u.shape[1], u.shape[0]
        if self._has_pad_leak():
            # Carry the grained padding into the next frame's buffer.
            self._pbuf = [np.asarray(yo).astype(dt), np.asarray(uo).astype(dt),
                          np.asarray(vo).astype(dt)]
        return (np.asarray(yo)[:self.height, :self.width].astype(dt),
                np.asarray(uo)[:ch, :cw].astype(dt),
                np.asarray(vo)[:ch, :cw].astype(dt))

    # ------------------------------------------------------------------

    def run(self, fsrc, fdst, frames: int = 0, odepth: int = 0) -> int:
        """Full frame loop (vfgs_main.c:762-796). Returns frames written."""
        odepth = odepth or self.depth
        assert odepth in (8, 10) and odepth <= self.depth
        yuv.skip_frames(fsrc, self.seek, self.width, self.height,
                        self.depth, self.fmt)
        n = 0
        while frames == 0 or n < frames:
            self.maybe_switch_config(n)
            planes = yuv.read_frame(fsrc, self.width, self.height,
                                    self.depth, self.fmt)
            if planes is None:
                break
            out = self._run_engine(planes, n)
            if odepth < self.depth:
                out = yuv.to_8bit(out)
            yuv.write_frame(fdst, out, odepth)
            n += 1
        return n

    # -- batched high-throughput file pipeline --------------------------

    def _split_frame(self, raw: np.ndarray):
        """View a raw frame byte buffer as (Y, U, V) planes."""
        w, h = self.width, self.height
        cw, ch = yuv.chroma_dims(w, h, self.fmt)
        dt = np.uint8 if self.depth == 8 else np.dtype("<u2")
        arr = raw.view(dt)
        y = arr[:w * h].reshape(h, w)
        u = arr[w * h:w * h + cw * ch].reshape(ch, cw)
        v = arr[w * h + cw * ch:w * h + 2 * cw * ch].reshape(ch, cw)
        return y, u, v

    def run_file(self, src: str, dst: str, frames: int = 0, odepth: int = 0,
                 batch: int = 4, profile_dir: str | None = None,
                 verbose: bool = False) -> int:
        """Batched frame loop over file paths: prefetching native reader,
        async writer, one device dispatch per batch.  Bit-identical output
        to :meth:`run`; batches never straddle a config-switch POC.

        ``profile_dir`` captures a jax.profiler trace of the steady-state
        loop; ``verbose`` prints per-stage wall-clock to stderr."""
        import time as _time
        import jax.numpy as jnp
        try:
            from .utils import native_io
            use_native = native_io.available()
        except Exception:
            use_native = False

        def open_src():
            try:
                return open(src, "rb")
            except OSError:
                raise OSError(f"Can not open file {src}")

        def open_dst():
            try:
                return open(dst, "wb")
            except OSError:
                raise OSError(f"Can not create file {dst}")

        if batch <= 1 or self.engine == "ref" or self._has_pad_leak():
            # Pad-leak widths couple consecutive frames through the padding
            # columns (see _has_pad_leak), so they use the per-frame path.
            if batch > 1 and self._has_pad_leak():
                import sys as _sys
                print(f"[vfgs] note: width {self.width} leaves a one-"
                      "sample deblock read past the frame edge (component "
                      "width % block width == 1); the reference feeds its "
                      "persistent buffer padding across frames there, so "
                      "frames are processed one at a time to stay bit-exact "
                      "(slower than the batched path)", file=_sys.stderr)
            with open_src() as fs, open_dst() as fd:
                return self.run(fs, fd, frames=frames, odepth=odepth)

        odepth = odepth or self.depth
        assert odepth in (8, 10) and odepth <= self.depth
        fbytes = yuv.frame_bytes(self.width, self.height, self.depth, self.fmt)
        obytes = yuv.frame_bytes(self.width, self.height, odepth, self.fmt)
        R, C = self._R, self._C
        bhc, bwc = 16 // self.regs.csuby, 16 // self.regs.csubx
        pad_needed = (self.height % 16 or self.width % 16
                      or (self.height // self.regs.csuby) % bhc
                      or (self.width // self.regs.csubx) % bwc)

        if use_native:
            from .utils.native_io import FrameReader, FrameWriter
            reader = FrameReader(src, fbytes, nbuf=max(4, batch),
                                 seek_frames=self.seek)
            writer = FrameWriter(dst, obytes, nbuf=max(4, batch))
        else:
            fsrc = open_src()
            fdst = open_dst()
            yuv.skip_frames(fsrc, self.seek, self.width, self.height,
                            self.depth, self.fmt)

        def read_raw():
            if use_native:
                return reader.next()
            raw = fsrc.read(fbytes)
            if len(raw) != fbytes:
                return None
            return np.frombuffer(raw, dtype=np.uint8)

        n = 0
        eof = False
        pending = None  # (device_out, count, shapes)
        prof = None
        if profile_dir:
            import jax
            prof = jax.profiler.trace(profile_dir)
            prof.__enter__()
        t_read = t_step = t_write = 0.0
        t_start = _time.perf_counter()

        def prepare(n0):
            """Stage the batch starting at global frame ``n0``: pop any due
            config, read + pad the raw frames, START the async h2d of the
            planes, and resolve the engine step under the (possibly new)
            config.  Called for batch N+1 right after batch N's compute is
            enqueued, so the transfer overlaps the compute."""
            nonlocal eof, t_read
            if eof or (frames and n0 >= frames):
                return None
            self.maybe_switch_config(n0)
            # frames until the next config switch
            limit = batch
            if self.icfg < len(self.configs):
                limit = min(limit,
                            max(1, self.configs[self.icfg][0]
                                - (n0 + self.seek)))
            if frames:
                limit = min(limit, frames - n0)
            raws = []
            t0 = _time.perf_counter()
            for _ in range(limit):
                raw = read_raw()
                if raw is None:
                    eof = True
                    break
                raws.append(raw)
            t_read += _time.perf_counter() - t0
            if not raws:
                return None
            count = len(raws)
            while len(raws) < batch:      # pad to the compiled batch size
                raws.append(raws[-1])
            ys, us, vs = [], [], []
            for raw in raws:
                y, u, v = self._split_frame(raw)
                if pad_needed:
                    y = yuv.pad_plane(y, R * 16, C * 16)
                    u = yuv.pad_plane(u, R * bhc, C * bwc)
                    v = yuv.pad_plane(v, R * bhc, C * bwc)
                ys.append(y)
                us.append(u)
                vs.append(v)
            bases = np.empty(batch, np.uint32)
            bases_up = np.empty(batch, np.uint32)
            for i in range(batch):
                b, bu = self.frame_bases(n0 + min(i, count - 1))
                bases[i], bases_up[i] = b, bu
            # resolve the tables NOW: a later prepare() may pop the next
            # config before this batch is dispatched.  The planes are fresh
            # arrays per batch, so the step may donate them.
            step = self._batched_step(donate=True)
            extra = self._tables()
            # jax device transfers are asynchronous: these enqueue and
            # return, overlapping the previous batch's compute
            dev = (jnp.asarray(np.stack(ys)), jnp.asarray(np.stack(us)),
                   jnp.asarray(np.stack(vs)), jnp.asarray(bases),
                   jnp.asarray(bases_up))
            return step, extra, dev, count

        def flush(p):
            yo, uo, vo, count = p
            yo = np.asarray(yo)[:, :self.height, :self.width]
            cw, ch = yuv.chroma_dims(self.width, self.height, self.fmt)
            uo = np.asarray(uo)[:, :ch, :cw]
            vo = np.asarray(vo)[:, :ch, :cw]
            for i in range(count):
                planes = (yo[i], uo[i], vo[i])
                if odepth < self.depth:
                    planes = yuv.to_8bit(planes)
                if use_native:
                    buf = np.concatenate([np.ascontiguousarray(p).view(np.uint8).reshape(-1)
                                          for p in planes])
                    writer.put(buf)
                else:
                    yuv.write_frame(fdst, planes, odepth)

        try:
            cur = prepare(0)
            while cur is not None:
                step, extra, dev, count = cur
                t0 = _time.perf_counter()
                out = step(*dev, *extra)
                # Start the d2h of this batch now; by the time flush()
                # blocks on it (one batch later), the bytes are on the host.
                for o in out:
                    o.copy_to_host_async()
                t_step += _time.perf_counter() - t0
                n += count
                cur = prepare(n)      # h2d of batch N+1 under batch N
                t0 = _time.perf_counter()
                if pending is not None:
                    flush(pending)
                t_write += _time.perf_counter() - t0
                pending = (*out, count)
            t0 = _time.perf_counter()
            if pending is not None:
                flush(pending)
            t_write += _time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
            if verbose:
                import sys as _sys
                total = _time.perf_counter() - t_start
                fps = n / total if total > 0 else 0.0
                print(f"[vfgs] {n} frames in {total:.3f}s ({fps:.1f} fps) "
                      f"| read {t_read:.3f}s dispatch {t_step:.3f}s "
                      f"drain+write {t_write:.3f}s", file=_sys.stderr)
            if use_native:
                reader.close()
                writer.close()
            else:
                fsrc.close()
                fdst.close()
        return n
