"""Stratum tables: the spatial model of the paper.

The area of interest is a regular grid of geohash cells ("strata").  A
tuple's geohash resolves to a stratum by binary search over the sorted
table of cell codes, and the stratum to its coarser "neighborhood" by one
gather from a ``stratum -> neighborhood`` array — the vectorized form of
the paper's inverted hashmap.

Out-of-region tuples map to a dedicated overflow stratum (index ``S``), so
every downstream per-stratum reduction has the static size ``S + 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from . import geohash


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    There is no silent CPU fallback — a caller without a GPU passes
    ``device="cpu"`` explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class StratumTable:
    """Static table of geohash strata covering a region of interest.

    Attributes:
      codes: (S,) int32, sorted geohash codes of the in-region cells.
      neighborhood: (S + 1,) int32, neighborhood id per stratum; the final
        entry is the overflow stratum's own catch-all (``num_neighborhoods``).
      precision: geohash precision of the strata.
      neighborhood_precision: coarser precision defining neighborhoods.
      num_neighborhoods: count of distinct in-region neighborhoods.
    """

    codes: torch.Tensor
    neighborhood: torch.Tensor
    precision: int
    neighborhood_precision: int
    num_neighborhoods: int

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def num_strata(self) -> int:
        return int(self.codes.shape[0])

    @property
    def num_slots(self) -> int:
        """Strata + 1 overflow slot; the static segment count downstream."""
        return self.num_strata + 1

    def to(self, device) -> "StratumTable":
        return dataclasses.replace(
            self, codes=self.codes.to(device), neighborhood=self.neighborhood.to(device)
        )

    def lookup(self, codes: torch.Tensor) -> torch.Tensor:
        """Map geohash codes -> stratum index in [0, S]; S = out-of-region."""
        idx = torch.searchsorted(self.codes, codes.to(torch.int32), out_int32=True)
        idx = idx.clamp(0, self.num_strata - 1)
        hit = self.codes[idx] == codes
        return torch.where(hit, idx, self.num_strata)

    def assign(
        self, lat: torch.Tensor, lon: torch.Tensor, backend: str = "segment"
    ) -> torch.Tensor:
        """Coordinates -> stratum index (encode + table lookup).

        ``backend="pallas"`` or ``"fused"`` routes the encode through the
        geohash kernel's wrapper: the CUDA kernel on a CUDA tensor, its plain
        version on a CPU tensor (the two are bit-identical)."""
        if backend in ("pallas", "fused"):
            from ..kernels.geohash import geohash_encode

            codes = geohash_encode(lat, lon, self.precision)
        else:
            codes = geohash.encode(lat, lon, self.precision)
        return self.lookup(codes)

    def neighborhood_of(self, stratum_idx: torch.Tensor) -> torch.Tensor:
        """O(1) gather: stratum index -> neighborhood id."""
        return self.neighborhood[stratum_idx]


def _table(codes: np.ndarray, precision: int, neighborhood_precision: int, device) -> StratumTable:
    """Sorted unique int32 codes -> table with the neighborhood map."""
    parents = codes >> (5 * (precision - neighborhood_precision))
    uniq, inv = np.unique(parents, return_inverse=True)
    neighborhood = np.concatenate([inv.astype(np.int32), np.array([len(uniq)], dtype=np.int32)])
    dev = resolve_device(device)
    return StratumTable(
        codes=torch.as_tensor(codes.astype(np.int32), device=dev),
        neighborhood=torch.as_tensor(neighborhood, device=dev),
        precision=precision,
        neighborhood_precision=neighborhood_precision,
        num_neighborhoods=int(len(uniq)),
    )


def _neighborhood_precision(precision: int, neighborhood_precision: int | None) -> int:
    if neighborhood_precision is None:
        neighborhood_precision = max(1, precision - 2)
    if neighborhood_precision > precision:
        raise ValueError("neighborhood_precision must be <= precision")
    return neighborhood_precision


def make_table(
    lat_range: tuple[float, float],
    lon_range: tuple[float, float],
    precision: int,
    neighborhood_precision: int | None = None,
    device=None,
) -> StratumTable:
    """Enumerate the geohash cells covering a bounding box (host side).

    The paper's "area of interest divided into a regular grid of
    fixed-sized adjacent non-overlapping cells", built once at launch and
    used read-only on ``device`` (CUDA unless named)."""
    geohash.check_precision(precision)
    neighborhood_precision = _neighborhood_precision(precision, neighborhood_precision)
    lat_lo, lat_hi = lat_range
    lon_lo, lon_hi = lon_range
    lat_cell, lon_cell = geohash.cell_size_deg(precision)
    lat_i0 = int(np.floor((lat_lo - geohash.LAT_MIN) / lat_cell))
    lat_i1 = int(np.floor((lat_hi - geohash.LAT_MIN) / lat_cell - 1e-12))
    lon_i0 = int(np.floor((lon_lo - geohash.LON_MIN) / lon_cell))
    lon_i1 = int(np.floor((lon_hi - geohash.LON_MIN) / lon_cell - 1e-12))
    lat_idx = torch.arange(lat_i0, lat_i1 + 1, dtype=torch.int32)
    lon_idx = torch.arange(lon_i0, lon_i1 + 1, dtype=torch.int32)
    lat_grid, lon_grid = torch.meshgrid(lat_idx, lon_idx, indexing="ij")
    codes = geohash.interleave(lon_grid.reshape(-1), lat_grid.reshape(-1), precision)
    codes = np.sort(codes.numpy())
    return _table(codes, precision, neighborhood_precision, device)


def make_table_from_codes(
    codes: Sequence[int] | np.ndarray,
    precision: int,
    neighborhood_precision: int | None = None,
    device=None,
) -> StratumTable:
    """Build a table from an explicit set of geohash codes (e.g. observed)."""
    neighborhood_precision = _neighborhood_precision(precision, neighborhood_precision)
    codes = np.unique(np.asarray(codes, dtype=np.int64)).astype(np.int32)
    return _table(codes, precision, neighborhood_precision, device)


# Bounding boxes used across examples/benchmarks (approximate city extents).
SHENZHEN_BBOX = ((22.44, 22.87), (113.75, 114.65))
CHICAGO_BBOX = ((41.62, 42.05), (-87.95, -87.50))
