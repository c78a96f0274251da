"""Generate golden output checksums from the reference C binary.

Runs the reference ``vfgs`` binary (built from /root/reference into
/tmp/refbuild/vfgs) over deterministic synthetic inputs for every test case
and records sha256 checksums into tests/golden/checksums.json.  The test
suite replays the same cases through our CLI and compares hashes -- the
de-facto test methodology of the reference (deterministic YUV->YUV transform,
SURVEY.md section 4).

Usage:  python3 tools/gen_golden.py [vfgs_binary]
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(__file__))
from gen_input import make_input_yuv  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Vendored copies of the reference's cfg/ vectors (tests/golden/cfg/README.md)
# so the suite runs without /root/reference mounted.  Recorded args use the
# "$CFG" and "$EXTRA" placeholders, never absolute paths, so the checksums
# hold in any checkout; expand_cfg() resolves them at use time.
CFG_DIR = os.path.join(REPO, "tests", "golden", "cfg")
EXTRA_DIR = os.path.join(REPO, "tests", "golden", "cfg_extra")
CFG = "$CFG"
EXTRA = "$EXTRA"
FMT_NAMES = {0: "420", 1: "422", 2: "444"}

_CFG_EXTS = (".cfg", ".tbl", ".txt")


def expand_cfg(arg: str) -> str:
    return arg.replace(CFG, CFG_DIR).replace(EXTRA, EXTRA_DIR)


def build_cases():
    cases = []

    def add(name, w=256, h=192, depth=10, fmt=0, frames=3, args=(),
            in_frames=None):
        cases.append(dict(name=name, w=w, h=h, depth=depth, fmt=fmt,
                          frames=frames, in_frames=in_frames or max(frames, 1),
                          args=list(args)))

    # Every cfg vector shipped with the reference.
    for f in sorted(os.listdir(CFG_DIR)):
        if f.endswith(_CFG_EXTS):
            add(f"cfg_{f}", args=["-c", f"{CFG}/{f}"])

    # Our own extra vectors for paths the reference suite leaves untested
    # (8-pattern cap overflow, fill_model_array defaults, overlapping
    # intervals, alternative AR coefficients).
    for f in sorted(os.listdir(EXTRA_DIR)):
        add(f"extra_{f}", args=["-c", f"{EXTRA}/{f}"])

    # Default config paths.
    add("default_10b", args=[])
    add("default_8b", depth=8, args=[])
    # CLI feature matrix.
    add("outdepth8", args=["--outdepth", "8"])
    add("gain50", args=["-g", "50"])
    add("gain73", args=["-g", "73"])
    add("gain200", args=["-g", "200"])
    add("seed", args=["-r", "987654321"])
    add("seek2", frames=2, in_frames=5, args=["-s", "2"])
    # seek past a config POC: stale config pops collapse to frame 0
    add("seek_past_poc", frames=2, in_frames=5, args=[
        "-s", "2", "-c", f"1:{CFG}/fgs_afgs1_test1.cfg",
        "-c", f"4:{CFG}/fgs_sei_ff_test2.cfg"])
    add("odd_dims", w=250, h=150, args=[])
    # Pad-leak widths: the last deblock boundary reads one sample past the
    # real width, so the reference depends on its persistent buffer padding
    # (zeros, then grained) -- exercises the stateful padded-buffer path.
    add("padleak_luma_w193", w=193, h=160, args=[])
    add("padleak_chroma_w194", w=194, h=192, depth=8, args=[])
    add("padleak_chroma_w195_afgs1", w=195, h=160,
        args=["-c", f"{CFG}/fgs_afgs1_test3.cfg"])
    add("multi_cfg_poc", frames=5, args=[
        "-c", f"0:{CFG}/fgs_sei.cfg",
        "-c", f"1:{CFG}/fgs_sei_ff_test1.cfg",
        "-c", f"3:{CFG}/fgs_afgs1_test1.cfg"])
    add("multi_cfg_afgs1_to_sei", frames=4, args=[
        "-c", f"0:{CFG}/fgs_afgs1_test2.cfg",
        "-c", f"2:{CFG}/fgs_sei_ar_test1.cfg"])
    add("afgs1_8b_outdepth", depth=8, args=["-c", f"{CFG}/fgs_afgs1_test5.cfg"])
    add("ar_gain", args=["-c", f"{CFG}/fgs_sei_ar_test1.cfg", "-g", "60"])
    add("afgs1_seed_override", args=["-c", f"{CFG}/fgs_afgs1_test3.cfg",
                                     "-r", "55555"])
    add("dump_gain", args=["-c", f"{CFG}/fgs_sei_dump.txt", "-g", "140"])
    return cases


def input_path(tmp, case):
    key = (case["w"], case["h"], case["depth"], case["fmt"], case["in_frames"])
    path = os.path.join(tmp, "in_%dx%d_%db_%s_%df.yuv" % (
        case["w"], case["h"], case["depth"], FMT_NAMES[case["fmt"]],
        case["in_frames"]))
    if not os.path.exists(path):
        make_input_yuv(path, *key)
    return path


def cli_args(case, inp, out):
    return (["-w", str(case["w"]), "-h", str(case["h"]),
             "-b", str(case["depth"]), "-f", FMT_NAMES[case["fmt"]],
             "-n", str(case["frames"])]
            + [expand_cfg(a) for a in case["args"]] + [inp, out])


def main():
    vfgs = sys.argv[1] if len(sys.argv) > 1 else "/tmp/refbuild/vfgs"
    tmp = "/tmp/vfg_golden"
    os.makedirs(tmp, exist_ok=True)
    out_json = {}
    for case in build_cases():
        inp = input_path(tmp, case)
        out = os.path.join(tmp, "ref_" + case["name"] + ".yuv")
        r = subprocess.run([vfgs] + cli_args(case, inp, out),
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(f"SKIP {case['name']}: vfgs rc={r.returncode} "
                  f"{(r.stdout + r.stderr).strip().splitlines()[:1]}")
            continue
        digest = hashlib.sha256(open(out, "rb").read()).hexdigest()
        size = os.path.getsize(out)
        out_json[case["name"]] = dict(case=case, sha256=digest, bytes=size)
        print(f"OK   {case['name']}: {size} bytes {digest[:16]}")
    dst = os.path.join(REPO, "tests", "golden", "checksums.json")
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as f:
        json.dump(out_json, f, indent=1, sort_keys=True)
    print(f"wrote {dst}: {len(out_json)} cases")


if __name__ == "__main__":
    main()
