"""Host-CPU engine: the full sketch pipeline without touching a device.

Why it exists: an accelerator's fixed costs (jax import, backend start,
compile or program load, H2D transfer) dominate small jobs — the device
path spends most of a small job's wall on startup. This engine runs the same
hash -> sample -> count semantics as the device kernels, in the native C++
layer (packer.cpp ntcard_host_update / ntcard_host_hll_update), consuming
the SAME [batch_rows, chunk_len] packed batches (identical separator / halo
/ stride window ownership) — so outputs are byte-identical to the device
path by construction (cross-tested in tests/test_host_engine.py and the
randomized parity fuzzer).

Unlike the reference's file-level OpenMP loop (ntcard.cpp:445-467 — one
thread per FILE, serial on a single big input), the host engine threads
within each batch over rows, so a single large file scales across cores.

Engine selection lives in the CLIs (NTCARD_ENGINE=auto|host|device): "auto"
picks the host engine only for small inputs on accelerator platforms, where
it is strictly a latency optimization; large inputs stream to the device.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ntcard_tpu import native


def host_engine_available() -> bool:
    return native.get_lib() is not None


class HostCountTableSketch:
    """ntcard count-table sketch on the host: uint16 [nK, 2*r_buck] table
    (the reference's exact layout and wrap semantics, ntcard.cpp:437-439)
    plus exact int64 F1 counts. API-compatible with CountTableSketch for the
    CLI's purposes (update / finalize / save)."""

    def __init__(
        self,
        ks: Sequence[int],
        s_bits: int,
        r_bits: int,
        stride: int,
        gap_positions: Sequence[int] | None = None,
        n_threads: int = 0,
    ):
        if stride % 8 or stride < 8:
            raise ValueError(
                f"stride ({stride}) must be a positive multiple of 8 — use "
                "io.packing.aligned_stride(chunk_len, kmax)"
            )
        self.ks = tuple(ks)
        self.s_bits = s_bits
        self.r_bits = r_bits
        self.stride = stride
        self.gap_positions = tuple(gap_positions) if gap_positions else None
        self.r_buck = 1 << r_bits
        self.n_threads = n_threads
        nk = len(self.ks)
        self.tables = np.zeros((nk, 2 * self.r_buck), np.uint16)
        self.f1s = np.zeros((nk,), np.int64)

    def update(self, codes: np.ndarray, packed: bool = False) -> None:
        if packed:
            raise ValueError("host engine consumes raw [B, L] code batches")
        native.host_update(
            codes,
            self.stride,
            self.ks,
            self.s_bits,
            self.r_bits,
            self.tables,
            self.f1s,
            mask_positions=self.gap_positions,
            n_threads=self.n_threads,
        )

    def save(self, path: str) -> None:
        """Checkpoint in the CountTableSketch format (int32 tables + sentinel
        column) so host/device partial sketches merge interchangeably —
        summing uint16-wrapped counts mod 2^16 equals summing unwrapped
        counts mod 2^16."""
        nk = len(self.ks)
        t32 = np.zeros((nk, 2 * self.r_buck + 1), np.int32)
        t32[:, : 2 * self.r_buck] = self.tables
        np.savez_compressed(
            path,
            tables=t32,
            f1s=self.f1s.astype(np.int64),
            ks=np.asarray(self.ks, np.int64),
            s_bits=self.s_bits,
            r_bits=self.r_bits,
            stride=self.stride,
            gap=np.asarray(self.gap_positions or [], np.int64),
        )

    def finalize(self, return_table: bool = False, cov_max: int = 65535) -> Dict[int, dict]:
        """Same result dict as CountTableSketch.finalize: per-k counter-value
        histograms over bins 0..cov_max (native threaded scan) + exact F1."""
        nbins = min(cov_max + 1, 65536)
        out = {}
        for i, k in enumerate(self.ks):
            hist = np.empty((2, nbins), np.int64)
            for s in range(2):
                row = self.tables[i, s * self.r_buck : (s + 1) * self.r_buck]
                h = native.hist_u16_direct(row)
                if h is None:  # toolchain vanished mid-run; numpy fallback
                    h = np.bincount(row, minlength=65536)
                hist[s] = h[:nbins]
            out[k] = {"hist": hist, "f1": int(self.f1s[i])}
            if return_table:
                out[k]["table"] = self.tables[i].reshape(2, self.r_buck).copy()
        return out


class HostHllSketch:
    """nthll HyperLogLog sketch on the host: uint8 [2^n_bits] registers,
    max-merge semantics identical to models/hll.HllSketch."""

    def __init__(self, k: int, n_bits: int, stride: int, n_threads: int = 0):
        if stride % 8 or stride < 8:
            raise ValueError(f"stride ({stride}) must be a positive multiple of 8")
        self.k = k
        self.n_bits = n_bits
        self.n_buck = 1 << n_bits
        self.stride = stride
        self.n_threads = n_threads
        self.regs = np.zeros((self.n_buck,), np.uint8)

    def update(self, codes: np.ndarray, packed: bool = False) -> None:
        if packed:
            raise ValueError("host engine consumes raw [B, L] code batches")
        native.host_hll_update(
            codes, self.stride, self.k, self.n_bits, self.regs, self.n_threads
        )

    def registers(self) -> np.ndarray:
        return self.regs
