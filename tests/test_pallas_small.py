"""The Triton-route alpha FISTA / Frank-Wolfe kernels (run interpreted
here) against the jnp loops, and the choice between the two."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from demethify_tpu.ops import pallas_small
from demethify_tpu.ops.fista import fista_alpha_gram
from demethify_tpu.ops.frank_wolfe import frank_wolfe_gram
from demethify_tpu.ops.gram import sample_grams

_TRITON_CALL = "__gpu$xla.gpu.triton"


def _grams(n_cpg=150, n_s=7, p=6, seed=0):
    rng = np.random.default_rng(seed)
    R = rng.uniform(size=(n_cpg, p))
    d = rng.poisson(50, size=(n_cpg, n_s)) + 1.0
    y = np.clip(R @ rng.dirichlet(np.ones(p), size=n_s).T
                + 0.01 * rng.normal(size=(n_cpg, n_s)), 0, 1)
    G, b, _ = sample_grams(jnp.asarray(R), jnp.asarray(d), jnp.asarray(y))
    l_h = jnp.asarray(np.linalg.norm(R) ** 2 * d.max() ** 2)
    alpha = jnp.asarray(rng.dirichlet(np.ones(p), size=n_s).T)
    return G, b, l_h, alpha, rng


def _purity_start(alpha, p1, rng):
    n_s = alpha.shape[1]
    purity = jnp.asarray(rng.uniform(0.2, 0.8, size=n_s))
    a1 = alpha[:p1] / jnp.sum(alpha[:p1], axis=0) * purity
    a2 = alpha[p1:] / jnp.sum(alpha[p1:], axis=0) * (1.0 - purity)
    return a1, a2, purity


class TestAlphaKernel:
    @pytest.mark.parametrize("p", [2, 6, 9, 29])
    def test_trajectory_matches_jnp_loop(self, p):
        # p = 2, 6 pad to 8 rows, 9 to 16, 29 to 32
        G, b, l_h, alpha, rng = _grams(p=p)
        alpha_prev = jnp.asarray(rng.dirichlet(np.ones(p), size=7).T)
        a0 = jnp.asarray(1.7)
        want = fista_alpha_gram(alpha, alpha_prev, a0, 0.8 * l_h, l_h, G,
                                b, 20)
        got = pallas_small.fista_alpha(alpha, alpha_prev, a0, 0.8 * l_h,
                                       l_h, G, b, 20, interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=0, atol=1e-12)

    def test_masked_rows(self):
        G, b, l_h, alpha, _ = _grams()
        mask = jnp.asarray(np.arange(6) < 4)
        alpha = jnp.where(mask[:, None], alpha, 0.0)
        alpha = alpha / jnp.sum(alpha, axis=0)
        want = fista_alpha_gram(alpha, alpha, jnp.ones(()), l_h, l_h, G, b,
                                12, row_mask=mask)
        got = pallas_small.fista_alpha(alpha, alpha, jnp.ones(()), l_h, l_h,
                                       G, b, 12, mask, interpret=True)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                                   atol=1e-12)
        np.testing.assert_array_equal(np.asarray(got[0])[4:], 0.0)

    def test_vmapped_members(self):
        # members (restarts / replicates) batch through vmap: each member
        # must equal its own unbatched loop
        G, b, l_h, alpha, rng = _grams()
        alphas = jnp.stack([alpha] + [
            jnp.asarray(rng.dirichlet(np.ones(6), size=7).T)
            for _ in range(3)])
        scale = jnp.asarray([1.0, 1.1, 1.5, 2.0])

        def run(loop):
            return jax.vmap(lambda a, s: loop(a, s)[0])(alphas, scale)

        got = run(lambda a, s: pallas_small.fista_alpha(
            a, a, jnp.ones(()), s * l_h, s * l_h, G, b, 10,
            interpret=True))
        want = run(lambda a, s: fista_alpha_gram(
            a, a, jnp.ones(()), s * l_h, s * l_h, G, b, 10))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-12)


class TestFrankWolfeKernel:
    @pytest.mark.parametrize("p, p1", [(6, 5), (9, 5), (29, 25)])
    def test_matches_jnp_loop(self, p, p1):
        G, b, _, alpha, rng = _grams(p=p, seed=3)
        a1, a2, purity = _purity_start(alpha, p1, rng)
        want = frank_wolfe_gram(a1, a2, G, b, purity, 40)
        got = pallas_small.frank_wolfe(a1, a2, G, b, purity, 40,
                                       interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       atol=1e-12)
        # the purity constraint holds exactly per block
        np.testing.assert_allclose(np.asarray(jnp.sum(got[0], axis=0)),
                                   np.asarray(purity), atol=1e-12)

    def test_vmapped_members(self):
        G, b, _, alpha, rng = _grams(seed=4)
        starts = [_purity_start(
            jnp.asarray(rng.dirichlet(np.ones(6), size=7).T), 5, rng)
            for _ in range(3)]
        a1 = jnp.stack([s[0] for s in starts])
        a2 = jnp.stack([s[1] for s in starts])
        pur = jnp.stack([s[2] for s in starts])
        got = jax.vmap(lambda x1, x2, q: pallas_small.frank_wolfe(
            x1, x2, G, b, q, 25, interpret=True))(a1, a2, pur)
        want = jax.vmap(lambda x1, x2, q: frank_wolfe_gram(
            x1, x2, G, b, q, 25))(a1, a2, pur)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       atol=1e-12)


class TestKernelChoice:
    @pytest.mark.parametrize("platform, p, dtype, expected", [
        ("cuda", 6, jnp.float32, True),
        ("cuda", 32, jnp.float32, True),
        ("cuda", 33, jnp.float32, False),      # pads past MAX_P
        ("cuda", 6, jnp.float64, False),
        ("cuda", 6, jnp.bfloat16, False),
        ("cpu", 6, jnp.float32, False),
        ("default", 6, jnp.float32, False),
    ])
    def test_use_kernel(self, platform, p, dtype, expected):
        assert pallas_small.use_kernel(platform, p, dtype) is expected

    @pytest.mark.parametrize("p, padded", [(1, 8), (6, 8), (8, 8), (9, 16),
                                           (29, 32)])
    def test_padded_p(self, p, padded):
        assert pallas_small.padded_p(p) == padded

    def test_interpret_is_never_defaulted(self):
        G, b, l_h, alpha, _ = _grams()
        with pytest.raises(TypeError):
            pallas_small.fista_alpha(alpha, alpha, jnp.ones(()), l_h, l_h,
                                     G, b, 3)
        with pytest.raises(TypeError):
            pallas_small.frank_wolfe(alpha[:5], alpha[5:], G, b,
                                     jnp.full((7,), 0.5), 3)

    def test_choice_does_not_read_the_backend(self, monkeypatch):
        def refuse():
            raise AssertionError("backend consulted")

        monkeypatch.setattr(jax, "default_backend", refuse)
        G, b, l_h, alpha, _ = _grams()
        got = jax.jit(lambda a: pallas_small.alpha_loop(
            a, a, jnp.ones(()), l_h, l_h, G, b, 5))(alpha)
        want = fista_alpha_gram(alpha, alpha, jnp.ones(()), l_h, l_h, G, b,
                                5)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                                   atol=1e-12)

    @pytest.mark.parametrize("p, kernel", [(6, True), (29, True),
                                           (40, False)])
    def test_cuda_lowering_takes_kernel_by_shape(self, p, kernel):
        # lowering for CUDA runs here without a card: the kernel's Triton
        # call appears exactly when use_kernel says so, and never in the
        # CPU lowering
        G, b, l_h, alpha, _ = _grams(p=p)
        f32 = [x.astype(jnp.float32) for x in (alpha, G, b, l_h)]

        def step(alpha, G, b, l_h):
            a = pallas_small.alpha_loop(alpha, alpha, jnp.ones((), alpha.dtype),
                                        l_h, l_h, G, b, 20)[0]
            pur = jnp.full((alpha.shape[1],), 0.5, alpha.dtype)
            f = pallas_small.fw_loop(alpha[:-1], alpha[-1:], G, b, pur, 30)
            return a, f

        exported = jax.export.export(
            jax.jit(step), platforms=["cuda"],
            disabled_checks=[
                jax.export.DisabledSafetyCheck.custom_call(_TRITON_CALL)],
        )(*f32)
        n_calls = exported.mlir_module().count("xla.gpu.triton")
        assert n_calls == (2 if kernel else 0)
        cpu_text = jax.jit(step).lower(*f32).as_text()
        assert "triton" not in cpu_text
