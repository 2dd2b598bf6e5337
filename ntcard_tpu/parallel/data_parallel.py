"""Data-parallel scale-out over a device mesh.

The reference's parallel model is OpenMP threads over files mutating one
shared atomic table (ntcard.cpp:445-467). The lift here (SURVEY.md
§2.6): shard the packed read-batch rows over a 1-D ``data`` mesh with
``shard_map``; every device folds its rows into a *private* count table
(HLL register set); the merge is a single summation (elementwise max) over
the device axis — the collective analog of the reference's atomics
(critical-section max-merge, nthll.cpp:238-244). Both folds commute, so
1-shard and N-shard runs produce bit-identical tables by construction
(tested in tests/test_sharding.py).

Multi-host: the same mesh spans hosts (jax.distributed.initialize); each
host packs only its slice of the input files, feeds its addressable shards,
and the final jnp.sum/jnp.max runs as a psum/pmax across devices and hosts.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Sequence

from ntcard_tpu import _jax_config  # noqa: F401  (platform/cache config before backend init)
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ntcard_tpu.ops.nthash import hll_scan


def data_mesh(n_devices: int = 0) -> Mesh:
    devs = jax.devices()
    if n_devices:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), ("data",))


@partial(
    jax.jit,
    static_argnames=("mesh", "ks", "stride", "s_bits", "r_bits", "mask_positions", "packed"),
    donate_argnums=(0, 1),
)
def _sketch_update_sharded(
    tables, f1s, codes, mesh, ks, stride, s_bits, r_bits, mask_positions, packed=False,
):
    """tables: tuple of nK [D, 2*rbuck+1] int32 arrays, f1s [D, nK, 2]
    uint32, both sharded on D; codes [D, rows, width] — one wire batch per
    shard (raw / nibble / quad / quad2, any format sketch.update takes) —
    or [D, n, rows, width] (a superbatch stack per shard), sharded on the
    leading device axis.

    Each device folds its own wire batch through models.sketch._update_impl
    — the IDENTICAL per-shard program as the single-device step (per-k
    separate tables, on-device wire decode, superbatch scan), so per-shard
    cost equals the single-device step by construction. The merge at
    finalize is a sum over D (the psum analog of the reference's
    shared-table atomics, ntcard.cpp:142-143). Returns (tables, f1s)."""

    from ntcard_tpu.models.sketch import _update_impl

    def local(tbl, f1, c):
        tbl = tuple(t[0] for t in tbl)
        f1 = f1[0]
        c = c[0]
        if c.ndim == 3:
            def body(carry, one):
                t, f = carry
                return _update_impl(
                    t, f, one, ks, stride, s_bits, r_bits, mask_positions, packed
                ), None

            (tbl, f1), _ = jax.lax.scan(body, (tbl, f1), c)
        else:
            tbl, f1 = _update_impl(
                tbl, f1, c, ks, stride, s_bits, r_bits, mask_positions, packed
            )
        return tuple(t[None] for t in tbl), f1[None]

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data")),
        check_vma=False,
    )(tables, f1s, codes)


@jax.jit
def _shard_merge(tables):
    """tuple of [D, T] sharded tables -> tuple of [T] merged tables (the
    psum analog of the reference's shared-table atomics). NOT donated:
    save() and finalize() may both merge the same live sketch."""
    return tuple(t.sum(axis=0) for t in tables)


class ShardedCountTableSketch:
    """Drop-in for models.sketch.CountTableSketch over an N-device mesh."""

    def __init__(
        self,
        ks: Sequence[int],
        s_bits: int,
        r_bits: int,
        stride: int,
        gap_positions: Sequence[int] | None = None,
        n_devices: int = 0,
    ):
        if stride % 8 or stride < 8:
            raise ValueError(
                f"stride ({stride}) must be a positive multiple of 8 — use "
                "io.packing.aligned_stride(chunk_len, kmax) so the sketch and "
                "packer agree on window ownership"
            )
        self.ks = tuple(ks)
        self.s_bits = s_bits
        self.r_bits = r_bits
        self.stride = stride
        self.gap_positions = tuple(gap_positions) if gap_positions else None
        self.r_buck = 1 << r_bits
        self.mesh = data_mesh(n_devices)
        self.n_dev = self.mesh.devices.size
        nk = len(self.ks)
        shard = NamedSharding(self.mesh, P("data"))
        # per-k SEPARATE [D, T] buffers, matching the single-device layout
        # (models/sketch._update_impl)
        self.tables = tuple(
            jax.device_put(
                jnp.zeros((self.n_dev, 2 * self.r_buck + 1), jnp.int32), shard
            )
            for _ in range(nk)
        )
        self.f1s = jax.device_put(jnp.zeros((self.n_dev, nk, 2), jnp.uint32), shard)
        self._row_sharding = shard

    def _f1_totals(self):
        """Exact per-k F1 summed over shards (one device->host transfer)."""
        vals = np.asarray(self.f1s)
        return [
            sum((int(vals[d, i, 0]) << 32) | int(vals[d, i, 1]) for d in range(self.n_dev))
            for i in range(len(self.ks))
        ]

    def update(self, codes: np.ndarray, packed: bool = False) -> None:
        """codes: [n_dev * rows, L] raw (or nibble wire when ``packed`` —
        rows decode independently, so an even row split is exact)."""
        d = self.n_dev
        self.update_shards(codes.reshape(d, codes.shape[0] // d, codes.shape[1]), packed)

    def update_shards(self, shards: np.ndarray, packed=False) -> None:
        """shards: [n_dev, rows, width] — one complete wire batch per shard
        (raw/nibble/quad/quad2; quad-family wires must be packed PER SHARD,
        io.packing.pack_shard_wires) — or [n_dev, n, rows, width] superbatch
        stacks. Every shard runs the identical single-device update program."""
        shards = jax.device_put(shards, self._row_sharding)
        self.tables, self.f1s = _sketch_update_sharded(
            self.tables,
            self.f1s,
            shards,
            self.mesh,
            self.ks,
            self.stride,
            self.s_bits,
            self.r_bits,
            self.gap_positions,
            packed,
        )

    def _merged_tables(self):
        return _shard_merge(self.tables)

    def save(self, path: str) -> None:
        """Checkpoint: merge shards and save in CountTableSketch format
        (models/sketch.py save/load — mergeable offline)."""
        merged = self._merged_tables()
        np.savez_compressed(
            path,
            tables=np.stack([np.asarray(t) for t in merged]),
            f1s=np.asarray(self._f1_totals(), np.int64),
            ks=np.asarray(self.ks, np.int64),
            s_bits=self.s_bits,
            r_bits=self.r_bits,
            stride=self.stride,
            gap=np.asarray(self.gap_positions or [], np.int64),
        )

    def finalize(self, return_table: bool = False, cov_max: int = 65535) -> Dict[int, dict]:
        from ntcard_tpu.models.sketch import _counter_hists

        f1s = self._f1_totals()
        nbins = min(cov_max + 1, 65536)
        merged = self._merged_tables()
        hists = np.asarray(_counter_hists(merged, self.r_buck, nbins))
        out = {}
        for i, k in enumerate(self.ks):
            out[k] = {"hist": hists[i].astype(np.int64), "f1": f1s[i]}
            if return_table:
                t = np.asarray(merged[i][: 2 * self.r_buck]).astype(np.uint16)
                out[k]["table"] = t.reshape(2, self.r_buck)
        return out


def sharded_backend() -> str:
    """Multi-device engine selection (NTCARD_SHARDED=chains|shardmap|auto).

    "chains" drives one PRIVATE single-device sketch per device
    (per-device donation chains; every device runs the IDENTICAL
    single-device program, so per-shard cost == single-device cost by
    construction) and merges at finalize. "shardmap" is the mesh-collective
    formulation (_sketch_update_sharded). They are bit-identical
    (tests/test_sharding.py; chip_smoke.py --four compares both with one
    device on the card). The default is chains on GPUs — the engine the
    single-device path already exercises — and shard_map on CPU meshes."""
    import os

    env = os.environ.get("NTCARD_SHARDED", "auto")
    if env in ("chains", "shardmap"):
        return env
    return "chains" if jax.devices()[0].platform != "cpu" else "shardmap"


def make_sharded_sketch(ks, s_bits, r_bits, stride, gap_positions=None, n_devices=0):
    """The CLI's multi-device count-table sketch, per sharded_backend()."""
    cls = (
        PerDeviceCountTableSketch
        if sharded_backend() == "chains"
        else ShardedCountTableSketch
    )
    return cls(ks, s_bits, r_bits, stride, gap_positions=gap_positions, n_devices=n_devices)


class PerDeviceCountTableSketch:
    """Data parallelism as per-device PRIVATE single-device sketches: shard d's
    wire batches feed a models.sketch.CountTableSketch whose buffers live on
    device d (independent donation chains dispatch concurrently), and the
    commutative sum merges them at finalize — the same bit-exactness
    argument as the shard_map engine. Every single-device step (quad2 wire
    decode, superbatch scan, fused finalize) runs unchanged per device."""

    def __init__(
        self,
        ks: Sequence[int],
        s_bits: int,
        r_bits: int,
        stride: int,
        gap_positions: Sequence[int] | None = None,
        n_devices: int = 0,
    ):
        from ntcard_tpu.models.sketch import CountTableSketch

        devs = jax.devices()
        if n_devices:
            devs = devs[:n_devices]
        self.devices = devs
        self.n_dev = len(devs)
        self.ks = tuple(ks)
        self.s_bits, self.r_bits, self.stride = s_bits, r_bits, stride
        self.gap_positions = tuple(gap_positions) if gap_positions else None
        self.r_buck = 1 << r_bits
        self._sketches = []
        for d in devs:
            with jax.default_device(d):
                self._sketches.append(
                    CountTableSketch(
                        ks, s_bits, r_bits, stride, gap_positions=gap_positions
                    )
                )

    def update(self, codes: np.ndarray, packed: bool = False) -> None:
        """codes: [n_dev * rows, L] raw (or nibble wire when ``packed``)."""
        d = self.n_dev
        self.update_shards(codes.reshape(d, codes.shape[0] // d, codes.shape[1]), packed)

    def update_shards(self, shards, packed=False) -> None:
        """shards: [n_dev, rows, width] (or [n_dev, n, rows, width] stacks),
        or a list of n_dev per-shard arrays already placed on their devices
        (pipeline.device_prefetch's chains put) — shard d dispatches to
        device d; the per-device programs run concurrently (independent
        donation chains)."""
        for i, (s, dev) in enumerate(zip(shards, self.devices)):
            with jax.default_device(dev):
                self._sketches[i].update(jax.device_put(s, dev), packed=packed)

    def put_shards(self, shards):
        """Host-side [n_dev, ...] stack -> list of per-device arrays (for
        the pipeline's transfer thread, so each shard rides one put straight
        to its device instead of bouncing through the default device)."""
        return [jax.device_put(shards[i], d) for i, d in enumerate(self.devices)]

    def _merged(self):
        """Fold every device's sketch into device 0's (tables ride one
        device-to-device transfer each — NVLink between the cards of one
        host)."""
        head = self._sketches[0]
        for other in self._sketches[1:]:
            other.tables = tuple(
                jax.device_put(t, self.devices[0]) for t in other.tables
            )
            other.f1s = jax.device_put(other.f1s, self.devices[0])
            head.merge_(other)
        self._sketches = [head]
        return head

    def save(self, path: str) -> None:
        self._merged().save(path)

    def finalize(self, return_table: bool = False, cov_max: int = 65535) -> Dict[int, dict]:
        return self._merged().finalize(return_table=return_table, cov_max=cov_max)


@partial(
    jax.jit, static_argnames=("mesh", "k", "stride", "n_bits", "packed"), donate_argnums=(0,)
)
def _hll_update_sharded(regs, codes, mesh, k, stride, n_bits, packed=False):
    def local(r, c):
        # codes per shard: [rows, L] (legacy row split) or [1, rows, width]
        # (one complete wire per shard, update_shards)
        c = c[0] if c.ndim == 3 else c
        reg_idx, run0 = hll_scan(c, k, stride, n_bits, packed=packed)
        return r[0].at[reg_idx].max(run0)[None]

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P("data"),
        check_vma=False,
    )(regs, codes)


def make_sharded_hll(k: int, n_bits: int, stride: int, n_devices: int = 0):
    """The CLI's multi-device HLL sketch, per sharded_backend()."""
    cls = PerDeviceHllSketch if sharded_backend() == "chains" else ShardedHllSketch
    return cls(k, n_bits, stride, n_devices=n_devices)


class PerDeviceHllSketch:
    """Per-device private HLL register sets, max-merged at the end — the
    chains analog of ShardedHllSketch (see PerDeviceCountTableSketch for
    why chains are the accelerator default)."""

    def __init__(self, k: int, n_bits: int, stride: int, n_devices: int = 0):
        from ntcard_tpu.models.hll import HllSketch

        devs = jax.devices()
        if n_devices:
            devs = devs[:n_devices]
        self.devices = devs
        self.n_dev = len(devs)
        self.k, self.n_bits, self.stride = k, n_bits, stride
        self.n_buck = 1 << n_bits
        self._sketches = []
        for d in devs:
            with jax.default_device(d):
                self._sketches.append(HllSketch(k, n_bits, stride))

    def update(self, codes: np.ndarray, packed: bool = False) -> None:
        d = self.n_dev
        self.update_shards(codes.reshape(d, codes.shape[0] // d, codes.shape[1]), packed)

    def update_shards(self, shards, packed=False) -> None:
        for i, (s, dev) in enumerate(zip(shards, self.devices)):
            with jax.default_device(dev):
                self._sketches[i].update(jax.device_put(s, dev), packed=packed)

    def registers(self) -> np.ndarray:
        regs = np.stack([np.asarray(s.regs) for s in self._sketches])
        return regs.max(axis=0).astype(np.uint8)


class ShardedHllSketch:
    def __init__(self, k: int, n_bits: int, stride: int, n_devices: int = 0):
        if stride % 8 or stride < 8:
            raise ValueError(
                f"stride ({stride}) must be a positive multiple of 8 — use "
                "io.packing.aligned_stride(chunk_len, kmax) so the sketch and "
                "packer agree on window ownership"
            )
        self.k = k
        self.n_bits = n_bits
        self.n_buck = 1 << n_bits
        self.stride = stride
        self.mesh = data_mesh(n_devices)
        self.n_dev = self.mesh.devices.size
        shard = NamedSharding(self.mesh, P("data"))
        self.regs = jax.device_put(jnp.zeros((self.n_dev, self.n_buck), jnp.int32), shard)
        self._row_sharding = shard

    def update(self, codes: np.ndarray, packed: bool = False) -> None:
        codes = jax.device_put(codes, self._row_sharding)
        self.regs = _hll_update_sharded(
            self.regs, codes, self.mesh, self.k, self.stride, self.n_bits, packed
        )

    def update_shards(self, shards, packed=False) -> None:
        """shards: [n_dev, rows, width] — one complete wire batch per shard
        (io.packing.pack_shard_wires)."""
        self.update(shards, packed)

    def registers(self) -> np.ndarray:
        return np.asarray(jnp.max(self.regs, axis=0)).astype(np.uint8)  # pmax analog
