"""Plain-NumPy oracle implementing the reference's update semantics
(rewritten from the mathematical definitions in SURVEY.md; the originals
are the reference's `demethify/deconvolution.py` and `init_func.py`). Used
only to check numerical parity of the JAX solvers, here and on the chip
(`chip_smoke.py`)."""

import numpy as np


def cost_w(y, R, alpha, d):
    r = y - R @ alpha
    return float(np.sum(d * r * r))


def proj_simplex_cols(v, z=1.0):
    # sort-based projection, last-index rho scan (deconvolution.py:20-37)
    p, n = v.shape
    out = np.empty_like(v)
    for i in range(n):
        u = np.sort(v[:, i])[::-1]
        pi = np.cumsum(u) - z
        rho = -1
        for j in range(p):
            if u[j] - pi[j] / (j + 1) > 0:
                rho = j
        theta = pi[rho] / (rho + 1)
        out[:, i] = np.maximum(v[:, i] - theta, 0)
    return out


def fista_u(u, alpha, n_steps, a, l_prev, l_cur, u_prev, y, R_trunc, n_u, d):
    # update_u semantics (deconvolution.py:80-90)
    a1 = a
    for _ in range(n_steps):
        a0 = a1
        a1 = (1 + np.sqrt(1 + 4 * a0 * a0)) / 2
        beta = min((a0 - 1) / a1, 0.9999 * np.sqrt(l_prev / l_cur))
        u_t = u + beta * (u - u_prev)
        u_prev = u
        resid = y - R_trunc @ alpha[:-n_u] - u_t @ alpha[-n_u:]
        u = np.clip(u_t + (d * resid) @ alpha[-n_u:].T / l_cur, 0, 1)
        l_prev = l_cur
    return u, u_prev, a1, l_prev


def fista_alpha(n_steps, alpha, a, l_prev, l_cur, alpha_prev, R, d, y):
    # update_alpha semantics (deconvolution.py:92-102)
    a2 = a
    for _ in range(n_steps):
        a0 = a2
        a2 = (1 + np.sqrt(1 + 4 * a0 * a0)) / 2
        beta = min((a0 - 1) / a2, 0.9999 * np.sqrt(l_prev / l_cur))
        a_t = alpha + beta * (alpha - alpha_prev)
        alpha_prev = alpha
        alpha = proj_simplex_cols(a_t + (R.T @ (d * (y - R @ a_t))) / l_cur)
        l_prev = l_cur
    return alpha, alpha_prev, a2, l_prev


def frank_wolfe(W1, W2, y, a1, a2, purity, max_iter, d, vertices=None):
    # frank_wolfe_nmf semantics (deconvolution.py:279-302). A list given as
    # ``vertices`` receives each step's known-block (argmin, margin) per
    # column: margin = second-smallest minus smallest gradient entry.
    a1 = a1.copy()
    a2 = a2.copy()
    for k in range(max_iter):
        resid = d * (y - W1 @ a1 - W2 @ a2)
        g1 = -W1.T @ resid
        g2 = -W2.T @ resid
        if vertices is not None:
            g_sorted = np.sort(g1, axis=0)
            vertices.append((np.argmin(g1, axis=0),
                             g_sorted[1] - g_sorted[0]))
        s1 = np.zeros_like(a1)
        s2 = np.zeros_like(a2)
        for col in range(a1.shape[1]):
            s1[np.argmin(g1[:, col]), col] = purity[col]
            s2[np.argmin(g2[:, col]), col] = 1 - purity[col]
        gamma = 2 / (k + 2)
        a1 = (1 - gamma) * a1 + gamma * s1
        a2 = (1 - gamma) * a2 + gamma * s2
    return a1, a2


def partial_ref_solve(u, R, alpha, y, d, R_trunc, n_u,
                      n_iter1, n_iter2, tol):
    # mdwbssmf_deconv semantics (deconvolution.py:190-223)
    a1 = 1.0
    a2 = 1.0
    u_prev = u.copy()
    alpha_prev = alpha.copy()
    dmax2 = d.max() ** 2
    l_w = np.linalg.norm(alpha[-n_u:]) ** 2 * dmax2
    l_w_prev = l_w
    l_h = np.linalg.norm(R) ** 2 * dmax2
    l_h_prev = l_h
    cf = cost_w(y, R, alpha, d)
    for _ in range(n_iter1):
        cf0 = cf
        u, u_prev, a1, l_w_prev = fista_u(
            u, alpha, n_iter2, a1, l_w_prev, l_w, u_prev, y, R_trunc, n_u, d)
        R = np.hstack([R_trunc, u.reshape(-1, n_u)])
        l_h = np.linalg.norm(R) ** 2 * dmax2
        alpha, alpha_prev, a2, l_h_prev = fista_alpha(
            n_iter2, alpha, a2, l_h_prev, l_h, alpha_prev, R, d, y)
        l_w = np.linalg.norm(alpha[-n_u:]) ** 2 * dmax2
        cf = cost_w(y, R, alpha, d)
        if abs(cf - cf0) < tol:
            break
    return u, alpha


def unsupervised_solve(u, alpha, y, d, n_u, n_iter1, n_iter2, tol):
    # unsupervised_deconv main loop semantics (deconvolution.py:139-184)
    a1 = 1.0
    a2 = 1.0
    u_prev = u.copy()
    alpha_prev = alpha.copy()
    dmax2 = d.max() ** 2
    l_w = np.linalg.norm(alpha[-n_u:]) ** 2 * dmax2
    l_w_prev = l_w
    l_h = np.linalg.norm(u) ** 2 * dmax2
    l_h_prev = l_h
    cf = cost_w(y, u, alpha, d)
    for _ in range(n_iter1):
        cf0 = cf
        for _ in range(n_iter2):
            a0 = a1
            a1 = (1 + np.sqrt(1 + 4 * a0 * a0)) / 2
            beta = min((a0 - 1) / a1, 0.9999 * np.sqrt(l_w_prev / l_w))
            u_t = u + beta * (u - u_prev)
            u_prev = u
            # NOTE reference quirk (deconvolution.py:163): the unsupervised
            # inner-u gradient is evaluated at the *old* u, not at u_t.
            u = np.clip(u_t + (d * (y - u_prev @ alpha)) @ alpha.T / l_w,
                        0, 1)
            l_w_prev = l_w
        l_h = np.linalg.norm(u) ** 2 * dmax2
        alpha, alpha_prev, a2, l_h_prev = fista_alpha(
            n_iter2, alpha, a2, l_h_prev, l_h, alpha_prev, u, d, y)
        l_w = np.linalg.norm(alpha[-n_u:]) ** 2 * dmax2
        cf = cost_w(y, u, alpha, d)
        if abs(cf - cf0) < tol:
            break
    return u, alpha


def purity_solve(u, alpha, y, d, R_trunc, purity, n_u, n_iter1, n_iter2,
                 tol, record_last_loop=False):
    # mdwbssmf_deconv_p semantics (deconvolution.py:305-337): the FISTA
    # u-update, then n_iter2 Frank-Wolfe steps on the purity-split alpha.
    # With ``record_last_loop`` it also returns the last Frank-Wolfe loop's
    # starting alpha and its vertices (see frank_wolfe).
    last_loop = {}
    a1 = 1.0
    u_prev = u.copy()
    dmax2 = d.max() ** 2
    l_w = np.linalg.norm(alpha[-n_u:]) ** 2 * dmax2
    l_w_prev = l_w
    R = np.hstack([R_trunc, u])
    cf = cost_w(y, R, alpha, d)
    for _ in range(n_iter1):
        cf0 = cf
        u, u_prev, a1, l_w_prev = fista_u(
            u, alpha, n_iter2, a1, l_w_prev, l_w, u_prev, y, R_trunc, n_u, d)
        vertices = [] if record_last_loop else None
        last_loop.update(alpha_in=alpha, vertices=vertices)
        al1, al2 = frank_wolfe(R_trunc, u, y, alpha[:-n_u], alpha[-n_u:],
                               purity, n_iter2, d, vertices)
        alpha = np.vstack([al1, al2])
        R = np.hstack([R_trunc, u])
        l_w = np.linalg.norm(alpha[-n_u:]) ** 2 * dmax2
        cf = cost_w(y, R, alpha, d)
        if abs(cf - cf0) < tol:
            break
    if record_last_loop:
        return u, alpha, last_loop
    return u, alpha


def wls_intercept(y, w, X):
    # init_func.wls_intercept semantics (init_func.py:8-14): sklearn's
    # LinearRegression(positive=True) with sample weights = weighted
    # centering, sqrt(w) row scaling, scipy nnls; intercept dropped,
    # coefficients normalized with a 1e-10 sum floor
    from scipy.optimize import nnls

    x_off = w @ X / w.sum()
    y_off = w @ y / w.sum()
    sw = np.sqrt(w)
    coef, _ = nnls((X - x_off) * sw[:, None], (y - y_off) * sw)
    return coef / max(coef.sum(), 1e-10)
