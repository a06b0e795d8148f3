"""Synthetic generators matching the paper's two evaluation datasets.

The paper evaluates on (1) Shenzhen electric-taxi GPS trajectories
(~664 vehicles, ~1.16M tuples: id, ts, lat, lon, speed) and (2) Chicago
hyperlocal air quality from Project Eclipse (~130K tuples: id, ts, lat,
lon, PM2.5).  The generators produce streams with the same statistical
shape:

  * mobility — vehicles random-walk inside the Shenzhen bbox around a few
    dense "downtown" attractors (slow, heavy traffic) with sparse outskirts
    (fast, few tuples): a spatially correlated value field;
  * air quality — fixed, heavily clustered sensors; PM2.5 = smooth spatial
    field + temporal drift + heteroscedastic noise.

Chunks are dicts (sensor_id, timestamp, lat, lon, value, plus a second
value column: ``occupancy`` for mobility, ``temperature`` for air quality).
The same seed yields the same arrays as the reference package's generators.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..core.stratify import CHICAGO_BBOX, SHENZHEN_BBOX


def _attractors(rng, bbox, k):
    (lat_lo, lat_hi), (lon_lo, lon_hi) = bbox
    lats = rng.uniform(lat_lo + 0.1 * (lat_hi - lat_lo), lat_hi - 0.1 * (lat_hi - lat_lo), k)
    lons = rng.uniform(lon_lo + 0.1 * (lon_hi - lon_lo), lon_hi - 0.1 * (lon_hi - lon_lo), k)
    return np.stack([lats, lons], axis=1)


def shenzhen_taxi_stream(
    num_vehicles: int = 664,
    chunk_size: int = 20_000,
    num_chunks: int = 60,
    seed: int = 0,
    bbox=SHENZHEN_BBOX,
) -> Iterator[dict]:
    """Mobility stream: ~num_chunks * chunk_size tuples of (id,ts,lat,lon,speed)."""
    rng = np.random.default_rng(seed)
    (lat_lo, lat_hi), (lon_lo, lon_hi) = bbox
    centers = _attractors(rng, bbox, 5)
    # each vehicle orbits a home attractor; 70% of vehicles in the top-2
    home = rng.choice(len(centers), num_vehicles, p=[0.45, 0.25, 0.15, 0.10, 0.05])
    pos = centers[home] + rng.normal(0, 0.02, (num_vehicles, 2))
    t = 0.0
    for _ in range(num_chunks):
        ids = rng.integers(0, num_vehicles, chunk_size)
        # random walk + pull toward home attractor
        step = rng.normal(0, 0.004, (chunk_size, 2))
        pull = (centers[home[ids]] - pos[ids]) * 0.05
        pos_ids = pos[ids] + step + pull
        pos_ids[:, 0] = np.clip(pos_ids[:, 0], lat_lo, lat_hi)
        pos_ids[:, 1] = np.clip(pos_ids[:, 1], lon_lo, lon_hi)
        pos[ids] = pos_ids
        # speed: slow near attractors (congestion), faster outside
        d = np.min(np.linalg.norm(pos_ids[:, None, :] - centers[None, :, :], axis=-1), axis=1)
        speed = 12.0 + 55.0 * np.tanh(d / 0.08) + rng.normal(0, 4.0, chunk_size)
        speed = np.clip(speed, 0.0, 120.0)
        # occupancy: anti-correlated with speed, spatially smooth
        occupancy = np.clip(
            0.85 - 0.6 * np.tanh(d / 0.08) + rng.normal(0, 0.08, chunk_size), 0.0, 1.0
        )
        ts = t + np.sort(rng.uniform(0, 60.0, chunk_size))
        t += 60.0
        yield dict(
            sensor_id=ids.astype(np.int32),
            timestamp=ts,
            lat=pos_ids[:, 0].astype(np.float32),
            lon=pos_ids[:, 1].astype(np.float32),
            value=speed.astype(np.float32),
            occupancy=occupancy.astype(np.float32),
        )


def chicago_aq_stream(
    num_sensors: int = 120,
    chunk_size: int = 10_000,
    num_chunks: int = 13,
    seed: int = 1,
    bbox=CHICAGO_BBOX,
) -> Iterator[dict]:
    """Air-quality stream: clustered fixed sensors, smooth PM2.5 field."""
    rng = np.random.default_rng(seed)
    (lat_lo, lat_hi), (lon_lo, lon_hi) = bbox
    clusters = _attractors(rng, bbox, 4)
    which = rng.choice(len(clusters), num_sensors, p=[0.5, 0.3, 0.15, 0.05])
    sensor_pos = clusters[which] + rng.normal(0, 0.015, (num_sensors, 2))
    sensor_pos[:, 0] = np.clip(sensor_pos[:, 0], lat_lo, lat_hi)
    sensor_pos[:, 1] = np.clip(sensor_pos[:, 1], lon_lo, lon_hi)
    # smooth spatial PM2.5 baseline per sensor
    base = (
        18.0
        + 14.0 * np.sin((sensor_pos[:, 0] - lat_lo) / (lat_hi - lat_lo) * np.pi)
        + 9.0 * np.cos((sensor_pos[:, 1] - lon_lo) / (lon_hi - lon_lo) * 2 * np.pi)
    )
    t = 0.0
    for _ in range(num_chunks):
        ids = rng.integers(0, num_sensors, chunk_size)
        drift = 4.0 * np.sin(2 * np.pi * (t / 86_400.0))  # diurnal cycle
        pm = base[ids] + drift + rng.gamma(2.0, 1.5, chunk_size) - 3.0
        pm = np.clip(pm, 0.5, 150.0)
        # temperature: lakefront gradient + diurnal swing + sensor noise
        temp = (
            22.0
            - 6.0 * (sensor_pos[ids, 1] - lon_lo) / (lon_hi - lon_lo)
            + 5.0 * np.sin(2 * np.pi * (t / 86_400.0) - np.pi / 3)
            + rng.normal(0, 0.8, chunk_size)
        )
        ts = t + np.sort(rng.uniform(0, 600.0, chunk_size))
        t += 600.0
        yield dict(
            sensor_id=ids.astype(np.int32),
            timestamp=ts,
            lat=sensor_pos[ids, 0].astype(np.float32),
            lon=sensor_pos[ids, 1].astype(np.float32),
            value=pm.astype(np.float32),
            temperature=temp.astype(np.float32),
        )


def materialize(stream: Iterator[dict]) -> dict:
    """Concatenate a finite stream into one dict of arrays."""
    chunks = list(stream)
    return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
