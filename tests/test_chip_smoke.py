"""chip_smoke.py off the card: it refuses to report without a GPU, and its
phases (kernel check, main path) are exact when rehearsed on the CPU at a
tiny size.  Also: the committed fixtures are what the extractor makes."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=240,
    )


def _ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            pass
    return False


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU, from the checkout or copied alone into an empty
    directory, the script exits non-zero and prints no result."""
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        r = _run_smoke(str(tmp_path), "chip_smoke.py")
    else:
        r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert not _ok_line(r.stdout)
    assert "not 'gpu'" in r.stderr


def test_smoke_kernel_phase_rehearsal():
    import chip_smoke

    out = chip_smoke.kernel_phase(jax.devices()[0], n_jobs=24)
    assert out["T"] == 640 and out["jobs"] == 24
    assert out["scan"]["gcups"] > 0 and out["early_exit"]["gcups"] > 0


def test_smoke_main_phase_rehearsal(tmp_path):
    import chip_smoke

    codes, img = chip_smoke.build_reference(
        300_000, chip_smoke.SEED, str(tmp_path)
    )
    out = chip_smoke.main_phase(jax.devices()[0], codes, img, n_pairs=24)
    assert out["reads"] == 48 and out["records"] >= 48
    assert out["fallbacks"] <= 0.02 * 48
    assert os.environ.get("BWAMEM_TPU_DEVICE_PIPELINE") is None


def test_fixtures_match_extractor(tmp_path):
    """tests/fixtures/ref.fa* are exactly what extract_rotavirus.py
    unpacks from rotavirus.bwa.img."""
    sys.path.insert(0, FIXTURES)
    try:
        import extract_rotavirus
    finally:
        sys.path.remove(FIXTURES)
    extract_rotavirus.main(out=str(tmp_path))
    for ext in ("", ".bwt", ".sa", ".pac", ".ann", ".amb"):
        with open(os.path.join(FIXTURES, "ref.fa" + ext), "rb") as fh:
            want = fh.read()
        with open(tmp_path / ("ref.fa" + ext), "rb") as fh:
            assert fh.read() == want, ext
