"""Where the persistent XLA compilation cache goes."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax, gf_orb_slam2_tpu as g; "
         "print(jax.config.jax_compilation_cache_dir)")


def cache_dir_in_subprocess(extra_env):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **extra_env)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_env_var_is_honoured_verbatim(tmp_path):
    want = str(tmp_path / "my cache")
    assert cache_dir_in_subprocess(
        {"JAX_COMPILATION_CACHE_DIR": want}) == want


@pytest.mark.parametrize("tmpdir_name", ["a", "b"])
def test_default_is_fixed_in_checkout(tmp_path, tmpdir_name):
    """Without the variable the cache sits at <repo>/.jax_cache/<machine
    fingerprint>: the same path from any process, whatever TMPDIR is."""
    tmp = tmp_path / tmpdir_name
    tmp.mkdir()
    got = cache_dir_in_subprocess({"TMPDIR": str(tmp)})
    from gf_orb_slam2_tpu import default_compile_cache_dir

    assert got == default_compile_cache_dir()
    assert os.path.dirname(got) == os.path.join(REPO, ".jax_cache")
    assert str(tmp) not in got and str(os.getpid()) not in got
