"""Kinematics tests — the JAX analogue of test_Kine_1/test_Kine_2 golden
tests: closed-form invariants instead of MATLAB constants."""
import jax.numpy as jnp
import numpy as np

from gf_orb_slam2_tpu.geometry import lie
from gf_orb_slam2_tpu.tracking import kinematics as kin


def state(rng):
    q = lie.rot_to_quat(lie.so3_exp(jnp.asarray(rng.normal(0, 0.4, 3), jnp.float32)))
    return kin.KineState(
        p=jnp.asarray(rng.normal(0, 1, 3), jnp.float32),
        q=q,
        v=jnp.asarray(rng.normal(0, 0.5, 3), jnp.float32),
        w=jnp.asarray(rng.normal(0, 0.3, 3), jnp.float32),
    )


class TestKinematics:
    def test_zero_dt_identity(self):
        s = state(np.random.default_rng(0))
        s2 = kin.predict(s, 0.0)
        np.testing.assert_allclose(np.asarray(s2.vector()), np.asarray(s.vector()), atol=1e-6)

    def test_linear_motion(self):
        s = state(np.random.default_rng(1))._replace(w=jnp.zeros(3))
        s2 = kin.predict(s, 0.5)
        np.testing.assert_allclose(
            np.asarray(s2.p), np.asarray(s.p + 0.5 * s.v), atol=1e-6
        )
        np.testing.assert_allclose(np.asarray(s2.q), np.asarray(s.q), atol=1e-6)

    def test_pwls_composition(self):
        """Two half-steps equal one full step for the CV model."""
        s = state(np.random.default_rng(2))
        a = kin.predict(s, 0.4)
        b = kin.predict_pwls(s, [0.2, 0.2])
        np.testing.assert_allclose(np.asarray(a.vector()), np.asarray(b.vector()), atol=1e-5)

    def test_process_jacobian_structure(self):
        """∂p'/∂p = I, ∂p'/∂v = dt·I, velocity rows untouched."""
        s = state(np.random.default_rng(3))
        J = np.asarray(kin.process_jacobian(s, 0.25))
        np.testing.assert_allclose(J[0:3, 0:3], np.eye(3), atol=1e-5)
        np.testing.assert_allclose(J[0:3, 7:10], 0.25 * np.eye(3), atol=1e-5)
        np.testing.assert_allclose(J[7:13, 0:7], 0.0, atol=1e-6)
        np.testing.assert_allclose(J[7:13, 7:13], np.eye(6), atol=1e-6)

    def test_state_from_poses_roundtrip(self):
        """Recover v/ω from two poses, predict, land on the second pose."""
        rng = np.random.default_rng(4)
        s = state(rng)
        dt = 0.1
        s2 = kin.predict(s, dt)
        R1, t1 = kin.pose_of(s)
        R2, t2 = kin.pose_of(s2)
        est = kin.state_from_poses(np.asarray(R1), np.asarray(t1),
                                   np.asarray(R2), np.asarray(t2), dt)
        s3 = kin.predict(est, dt)
        R3, t3 = kin.pose_of(s3)
        # predicted third pose ≈ extrapolation of the true CV motion
        s2b = kin.predict(s2, dt)
        R3t, t3t = kin.pose_of(s2b)
        np.testing.assert_allclose(np.asarray(t3), np.asarray(t3t), atol=2e-2)

    def test_odometry_buffer(self):
        buf = kin.OdometryBuffer()
        assert buf.predict_at(0.0) is None
        for i in range(10):
            buf.push(i * 0.1, np.eye(3), np.array([0, 0, i * 0.1]))
        R, t = buf.predict_at(0.52)
        np.testing.assert_allclose(t[2], 0.5, atol=1e-6)
        assert buf.predict_at(99.0) is None
