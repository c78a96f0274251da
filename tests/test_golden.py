"""Golden bit-exactness tests: replay every recorded case through our CLI and
compare sha256 against the reference binary's output (tests/golden/checksums.json,
regenerate with tools/gen_golden.py)."""

import hashlib
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from gen_input import make_input_yuv  # noqa: E402
from gen_golden import cli_args, expand_cfg, FMT_NAMES  # noqa: E402

GOLDEN = json.load(open(os.path.join(REPO, "tests", "golden",
                                     "checksums.json")))


def _input_path(tmpdir, case):
    path = os.path.join(tmpdir, "in_%dx%d_%db_%s_%df.yuv" % (
        case["w"], case["h"], case["depth"], FMT_NAMES[case["fmt"]],
        case["in_frames"]))
    if not os.path.exists(path):
        make_input_yuv(path, case["w"], case["h"], case["depth"],
                       case["fmt"], case["in_frames"])
    return path


def test_golden_cfg_args_portable():
    """Recorded cfg arguments carry placeholders, not absolute paths, and
    each resolves to a vendored file, so the goldens hold in any checkout."""
    for name, entry in GOLDEN.items():
        args = entry["case"]["args"]
        for flag, val in zip(args, args[1:]):
            if flag != "-c":
                continue
            path = val.split(":", 1)[1] if ":" in val else val
            assert path.startswith(("$CFG/", "$EXTRA/")), (name, val)
            assert os.path.isfile(expand_cfg(path)), (name, val)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden(name, tmp_path_factory):
    from versatilefilmgrain_tpu.cli import main

    tmpdir = str(tmp_path_factory.getbasetemp() / "inputs")
    os.makedirs(tmpdir, exist_ok=True)
    entry = GOLDEN[name]
    case = entry["case"]
    inp = _input_path(tmpdir, case)
    out = os.path.join(tmpdir, f"out_{name}.yuv")
    rc = main(["vfgs-tpu"] + cli_args(case, inp, out))
    assert rc == 0
    data = open(out, "rb").read()
    assert len(data) == entry["bytes"]
    assert hashlib.sha256(data).hexdigest() == entry["sha256"], \
        f"output differs from reference for {name}"
