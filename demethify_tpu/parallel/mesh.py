"""Device mesh and sharding layout for multi-chip deconvolution.

Design (SURVEY.md §2c): mesh axes ('replicate', 'cpg').

- 'cpg' row-shards the long axis (n_cpg, millions of sites genome-wide) of
  Y, D, R_trunc, U — the framework's context-parallelism. All cross-CpG
  reductions (per-sample Grams, u-constant terms, costs, NNLS normal
  equations) become XLA all-reduces (psum); the U FISTA steps are
  fully local to a shard (zero communication).
- 'replicate' data-parallels the embarrassingly parallel outer dimensions:
  random restarts, bootstrap replicates, BCV folds, IC-sweep members.
- alpha, Grams, and all O(p^2) state are replicated.

Everything rides `jax.jit` + `NamedSharding` constraint propagation — no
hand-written collectives; XLA chooses all-gather/psum placement from the
sharded operands.
"""

import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

REPLICATE_AXIS = "replicate"
CPG_AXIS = "cpg"


def factor_devices(n_devices: int, replicate: Optional[int] = None):
    """Split n_devices into (replicate, cpg). Default keeps the replicate
    axis SMALL (first divisor of 2/4/8 that fits), giving the cpg axis —
    the long sharded dimension — the majority of devices."""
    if replicate is None:
        replicate = 1
        for cand in (2, 4, 8):
            if n_devices % cand == 0 and n_devices // cand >= 1:
                replicate = cand
                break
    if n_devices % replicate:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"replicate={replicate}")
    return replicate, n_devices // replicate


def make_mesh(devices: Optional[Sequence] = None,
              replicate: Optional[int] = None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    rep, cpg = factor_devices(n, replicate)
    dev_arr = np.asarray(devices).reshape(rep, cpg)
    return Mesh(dev_arr, (REPLICATE_AXIS, CPG_AXIS))


def cpg_sharding(mesh: Mesh) -> NamedSharding:
    """Row-shard a (n_cpg, ...) array over the cpg axis."""
    return NamedSharding(mesh, P(CPG_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_cpg_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a (batch, n_cpg, ...) array over (replicate, cpg)."""
    return NamedSharding(mesh, P(REPLICATE_AXIS, CPG_AXIS, None))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a (batch, ...) array's leading axis over replicate only."""
    return NamedSharding(mesh, P(REPLICATE_AXIS))


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0,
                    fill: float = 0.0):
    """Pad the cpg axis so it divides the shard count. Zero-fill is
    semantically neutral for every reduction in this framework when the
    coverage weights D are also zero-padded (zero weight = site ignored)."""
    n = x.shape[axis]
    target = math.ceil(n / multiple) * multiple
    if target == n:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad, constant_values=fill), n


def shard_dataset(mesh: Mesh, y, d, ref=None):
    """Device-put (Y, D[, R]) with rows sharded over 'cpg'. Arrays whose
    row count doesn't divide the cpg axis are zero-padded (zero coverage
    weight makes padded sites inert in every Gram/cost reduction)."""
    n_shards = mesh.shape[CPG_AXIS]
    y_p, _ = pad_to_multiple(np.asarray(y), n_shards)
    d_p, _ = pad_to_multiple(np.asarray(d), n_shards)
    sh = cpg_sharding(mesh)
    out = [jax.device_put(y_p, sh), jax.device_put(d_p, sh)]
    if ref is not None:
        r_p, _ = pad_to_multiple(np.asarray(ref), n_shards)
        out.append(jax.device_put(r_p, sh))
    else:
        out.append(None)
    return tuple(out)
