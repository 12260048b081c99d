"""chip_smoke.py needs a GPU: on the CPU it must fail and print no result."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_smoke_fails_without_gpu(tmp_path, where):
    cwd = REPO
    if where == "alone":  # a directory holding the script and nothing else
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "FAILED" in out.stderr


def test_popcount_reference_matches_unpackbits():
    """The smoke's own Hamming reference (used on the GPU) is exact."""
    import numpy as np

    sys.path.insert(0, REPO)
    from chip_smoke import popcount_distances

    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (300, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (50, 8), dtype=np.uint32)
    want = np.unpackbits((a[:, None] ^ b[None]).view(np.uint8), -1).sum(-1)
    np.testing.assert_array_equal(popcount_distances(a, b), want)
