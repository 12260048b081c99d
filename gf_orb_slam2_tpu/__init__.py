"""Good-feature visual SLAM engine in JAX.

A brand-new JAX/XLA implementation with the capability set of GF-ORB-SLAM2
(see SURVEY.md): monocular/stereo/RGB-D tracking, local mapping with
good-graph bundle adjustment, loop closing, good-feature active matching, and
multi-index local-map hashing — built as SoA masked arrays, fixed-capacity
jitted programs, and a thin host orchestration layer.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent XLA compilation cache. JAX_COMPILATION_CACHE_DIR, when set,
# places it (JAX reads the variable itself and nothing here overrides it).
# Otherwise the cache lives at a fixed path inside the checkout,
# <repo>/.jax_cache/<fingerprint>. The fingerprint keys the machine: XLA:CPU
# stores AOT executables whose cache key does NOT include the compile
# machine's CPU features, so a cache populated on a different host can serve
# incompatible code (observed: SIGABRT and wrong numerics from avx512 blobs
# loaded on a non-avx512 host). It is stable on one machine.
_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def _machine_fingerprint() -> str:
    import hashlib
    import platform

    feat = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    feat = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    raw = f"{platform.machine()}|{_jax.__version__}|{feat}"
    return hashlib.sha1(raw.encode()).hexdigest()[:12]


def default_compile_cache_dir() -> str:
    """The in-checkout cache directory used when JAX_COMPILATION_CACHE_DIR
    is not set."""
    return _os.path.join(_REPO_ROOT, ".jax_cache", _machine_fingerprint())


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", default_compile_cache_dir())

from gf_orb_slam2_tpu.config import (  # noqa: F401
    CameraConfig,
    ORBConfig,
    TrackingConfig,
    GoodFeatureConfig,
    GoodGraphConfig,
    HashingConfig,
    SystemConfig,
    Sensor,
)
