"""Multi-host runtime: initialization and host-local sharded data loading.

The reference is single-process (SURVEY.md §2c: no distributed code of any
kind); this module is the TPU-native scale-out path. Design:

- `initialize()` wraps `jax.distributed.initialize` (no-op when
  single-process) so N hosts each driving a TPU slice join one runtime;
  collectives run between the devices of a host and across hosts.
- Each host loads only ITS contiguous row-block of the CpG axis
  (`host_row_block`), parses it with the native fastbed parser, and
  assembles the global sharded array with
  `jax.make_array_from_process_local_data` — no host ever materializes
  the full genome-scale matrix.
- Solvers are oblivious: they see one jax.Array row-sharded on the 'cpg'
  mesh axis, exactly as in single-host mode.
"""

from typing import List, Optional, Tuple

import numpy as np

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """Join the multi-host runtime. Safe no-op for single-process runs."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def host_row_block(n_rows: int, n_hosts: int, host_id: int
                   ) -> Tuple[int, int]:
    """Contiguous [start, end) row range owned by this host (balanced,
    first `n_rows % n_hosts` hosts take one extra row)."""
    base = n_rows // n_hosts
    extra = n_rows % n_hosts
    start = host_id * base + min(host_id, extra)
    end = start + base + (1 if host_id < extra else 0)
    return start, end


def make_global_cpg_array(mesh, local_rows: np.ndarray):
    """Assemble a globally row-sharded array from this process's local
    row block (rows must match the mesh's 'cpg' sharding for this host).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    from demethify_tpu.parallel.mesh import CPG_AXIS

    n_local = local_rows.shape[0]
    n_global = n_local * jax.process_count()
    sharding = NamedSharding(mesh, P(CPG_AXIS, None))
    return jax.make_array_from_process_local_data(
        sharding, local_rows, (n_global,) + local_rows.shape[1:])


def load_bedmethyl_shard(paths: List[str], n_hosts: int, host_id: int,
                         fillna: bool = False, dtype=np.float32):
    """Host-local shard of (meth_f, counts): parse only this host's row
    block of every sample file. Uses the native parser when available.

    Note: for maximal IO scaling each host should hold pre-split per-host
    BED files; this helper re-parses and slices as a convenience for
    shared filesystems.
    """
    from demethify_tpu.io.readers import read_bedmethyl_samples

    meth, counts = read_bedmethyl_samples(paths, fillna=fillna, dtype=dtype)
    start, end = host_row_block(meth.shape[0], n_hosts, host_id)
    return meth[start:end], counts[start:end]


def shard_dataset_global(meth: np.ndarray, counts: np.ndarray,
                         ref: Optional[np.ndarray]):
    """CLI --multihost data path: the host-parsed arrays are split into
    per-process contiguous CpG row blocks and assembled into globally
    row-sharded jax.Arrays over a mesh spanning ALL processes' devices
    (replicate=1; Gram reductions are cross-device sums).

    Returns (mesh, y, d, ref_or_None). Rows are zero-padded to the
    global shard count (zero coverage = inert rows).

    For maximal IO scaling pre-split per-host inputs and feed
    `make_global_cpg_array` directly; the CLI re-parses the shared files
    on every host as a convenience (the parse is the native fastbed
    parser, ~GB/s).
    """
    from demethify_tpu.parallel.mesh import (
        CPG_AXIS,
        cpg_sharding,
        make_mesh,
        pad_to_multiple,
    )

    mesh = make_mesh(jax.devices(), replicate=1)
    n_shards = mesh.shape[CPG_AXIS]
    nproc = jax.process_count()
    pid = jax.process_index()

    def shard_one(x):
        if x is None:
            return None
        x_p, _ = pad_to_multiple(np.asarray(x), n_shards)
        blk = x_p.shape[0] // nproc
        local = x_p[pid * blk:(pid + 1) * blk]
        return jax.make_array_from_process_local_data(
            cpg_sharding(mesh), local, x_p.shape)

    return mesh, shard_one(meth), shard_one(counts), shard_one(ref)


def addressable_row_block(arr) -> Tuple[np.ndarray, int]:
    """This process's contiguous row block of a cpg-row-sharded global
    array, plus its global starting row — for scalable per-host output
    writing (no host gathers the genome-scale factors)."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start)
    block = np.concatenate([np.asarray(s.data) for s in shards], axis=0)
    return block, shards[0].index[0].start


def replicated_to_host(arr) -> np.ndarray:
    """Host copy of a replicated (or single-device) array that is safe
    under multi-process execution (plain np.asarray requires full
    addressability). Raises on a sharded non-replicated array — shard 0
    would be silently partial data."""
    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    if not getattr(arr, "is_fully_replicated", False):
        raise ValueError(
            "replicated_to_host got a non-replicated multi-process "
            "array; gather it explicitly (addressable_row_block) "
            "instead")
    return np.asarray(arr.addressable_shards[0].data)
