"""Multi-host orchestration: the same data-parallel sketch over a mesh that
spans hosts (SURVEY.md §2.6, §5).

The reference is single-node shared-memory; its scale-out analog here is:

* ``jax.distributed.initialize()`` on every host (coordinator address from
  env or flags), giving one global mesh over all chips;
* deterministic input sharding: each host packs only its assigned slice of
  the input so no read is counted twice (assignment below);
* per-chip private tables as in data_parallel; the finalize-time
  ``jnp.sum``/``jnp.max`` over the device axis runs as a psum/pmax over
  the links between devices and between hosts;
* the merged histogram is independent of host count by commutativity — the
  same bit-exactness argument as the single-host shard-invariance tests.

Hosts are assigned files round-robin by (size-ordered) index, which balances
bytes approximately without any coordination; the assignment is a pure
function of (files, num_hosts), so every host computes the same partition.
Elastic recovery is intentionally out of scope (jobs are minutes; matches
reference capability — SURVEY.md §5 failure-detection notes).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize jax.distributed (no-op for single-process). Returns
    (process_id, num_processes)."""
    from ntcard_tpu import _jax_config  # noqa: F401
    import jax

    coordinator = coordinator or os.environ.get("NTCARD_COORDINATOR")
    if coordinator:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes
            if num_processes is not None
            else int(os.environ["NTCARD_NUM_PROCESSES"]),
            process_id=process_id
            if process_id is not None
            else int(os.environ["NTCARD_PROCESS_ID"]),
        )
    return jax.process_index(), jax.process_count()


def host_file_assignment(
    files: Sequence[str], sizes: Sequence[int], num_hosts: int, host_id: int
) -> List[str]:
    """Deterministic per-host file slice: greedy longest-processing-time —
    files sorted by (size desc, name) each go to the currently least-loaded
    host (ties by host index). Every host derives the identical global
    partition from the same inputs, so the union is exact and disjoint."""
    order = sorted(range(len(files)), key=lambda i: (-sizes[i], files[i]))
    loads = [0] * num_hosts
    mine: List[str] = []
    for i in order:
        h = min(range(num_hosts), key=lambda j: (loads[j], j))
        loads[h] += sizes[i]
        if h == host_id:
            mine.append(files[i])
    return mine


def global_data_mesh():
    """1-D 'data' mesh over every chip of every host."""
    from ntcard_tpu import _jax_config  # noqa: F401
    import jax
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), ("data",))


def _finalize_reduce_scatter(sketch, nbins: int):
    """Device-path cross-host merge: reduce-scatter the per-process tables
    over the process mesh (each device ends with a bucket shard of the
    SUMMED table — (P-1)/P of one table per link, the information-theoretic
    minimum for an exact per-bucket merge; hist-of-sum != sum-of-hists, so
    gathering histograms alone would be wrong), histogram the owned bucket
    shard on device, and psum the KB-scale histograms. Nothing GiB-scale
    ever lands on a host or is replicated. Returns [nK, 2, nbins] int32."""
    from ntcard_tpu import _jax_config  # noqa: F401
    import jax
    import jax.numpy as jnp
    import numpy as np
    from functools import partial
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ntcard_tpu.models.sketch import _hist_row

    procs = jax.process_count()
    me = jax.process_index()
    # one device per process carries that process's table
    firsts = {}
    for d in jax.devices():
        firsts.setdefault(d.process_index, d)
    devs = [firsts[p] for p in range(procs)]
    mesh = Mesh(np.asarray(devs), ("proc",))
    nk, r_buck = len(sketch.ks), sketch.r_buck

    local = jnp.stack(
        [t[: 2 * r_buck].reshape(2, r_buck) for t in sketch.tables]
    )[None]  # [1, nK, 2, r_buck] — drop the sentinel dump column
    g = jax.make_array_from_single_device_arrays(
        (procs, nk, 2, r_buck),
        NamedSharding(mesh, P("proc")),
        [jax.device_put(local, devs[me])],
    )
    hist_fn = partial(_hist_row, nbins=nbins)

    def local_fn(gs):  # [1, nK, 2, r_buck] = this process's table
        # each device ends with the bucket-range shard of the summed table
        chunk = jax.lax.psum_scatter(
            gs[0], "proc", scatter_dimension=2, tiled=True
        )  # [nK, 2, r_buck // P] int32; int32 sum is exact (uint16 counts
        # per process, wraps only past 2^15 processes) and the hist masks
        # to uint16 anyway
        rows = [hist_fn(chunk[i, s]) for i in range(nk) for s in range(2)]
        h = jnp.stack(rows).reshape(nk, 2, nbins)
        return jax.lax.psum(h, "proc")[None]

    out = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P("proc"),),
            out_specs=P("proc"),
            check_vma=False,
        )
    )(g)
    # every shard holds the identical psum'd histogram; read the local one
    return np.asarray(out.addressable_shards[0].data[0])


def merged_finalize(sketch, cov_max: int = 65535):
    """Cross-host finalize: merge every process's private count table (the
    psum analog of the reference's shared-table atomics, ntcard.cpp:142-143,
    lifted across hosts) and compute the counter-value histograms. Every
    process returns the identical result; addition commutes mod 2^16, so
    the merged histogram is bit-identical to a single-process run over the
    union of the inputs.

    The merge itself is a device-side reduce-scatter + histogram + tiny
    psum (_finalize_reduce_scatter) — at the default rBits=27 multi-k the
    old host path allgathered 3.2 GiB into every process's memory; now
    only KB-scale histograms are ever materialized. The host allgather
    survives as NTCARD_MULTIHOST_FINALIZE=host (debug/fallback, and the
    automatic route when the bucket count does not divide the process
    count).

    ``sketch`` is a models.sketch.CountTableSketch (per-host private state);
    single-process calls fall through to its own finalize()."""
    from ntcard_tpu import _jax_config  # noqa: F401
    import jax

    if jax.process_count() == 1:
        return sketch.finalize(cov_max=cov_max)

    import numpy as np
    from jax.experimental import multihost_utils

    from ntcard_tpu.utils.aot import check_trace_verifications

    check_trace_verifications()  # fast-key loads must verify before results
    f1_local = np.asarray(sketch._f1_totals(), np.int64)
    f1_all = multihost_utils.process_allgather(f1_local).sum(axis=0)
    nbins = min(cov_max + 1, 65536)

    # table-size routing: the reduce-scatter path exists so GiB-scale
    # default-r27 tables never materialize per-process (P x 3.2 GiB host
    # allgathers); for SMALL tables the collective program's per-run cost
    # dominates (measured on the 2-process Gloo proxy at r16: device path
    # finalize 5-7 s vs host allgather 0.8-2.4 s for 512 KB of tables) —
    # ship the bytes, skip the machinery
    table_bytes = len(sketch.ks) * (2 * sketch.r_buck + 1) * 4
    small = table_bytes * jax.process_count() <= int(
        os.environ.get("NTCARD_MULTIHOST_HOST_MAX", 256 << 20)
    )
    use_host = (
        os.environ.get("NTCARD_MULTIHOST_FINALIZE", "host" if small else "")
        == "host"
        or sketch.r_buck % jax.process_count() != 0
        or nbins >= 65536
    )
    if not use_host:
        hists = _finalize_reduce_scatter(sketch, nbins)
    else:
        import jax.numpy as jnp

        from ntcard_tpu.models.sketch import _counter_hists

        # host fallback: stack and allgather the full tables (P x table
        # bytes through the host network + host memory — debug only)
        local = np.stack([np.asarray(t) for t in sketch.tables])
        gathered = multihost_utils.process_allgather(local)
        # sum in int64 then wrap mod 2^16 — all the estimator ever reads
        merged = jnp.asarray(
            gathered.sum(axis=0, dtype=np.int64) & 0xFFFF, dtype=np.int32
        )
        hists = np.asarray(_counter_hists(merged, sketch.r_buck, nbins))

    out = {}
    for i, k in enumerate(sketch.ks):
        out[k] = {"hist": hists[i].astype(np.int64), "f1": int(f1_all[i])}
    return out


def merged_hll_registers(sketch) -> "np.ndarray":
    """Cross-host HLL merge: elementwise max over every process's registers
    (the pmax lift of nthll's critical-section merge, nthll.cpp:238-244)."""
    from ntcard_tpu import _jax_config  # noqa: F401
    import jax
    import numpy as np

    local = sketch.registers()
    if jax.process_count() == 1:
        return local
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(local.astype(np.int32))
    return gathered.max(axis=0).astype(np.uint8)
