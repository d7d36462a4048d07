"""Onshore/offshore hypocentre classification: the port of
``tqdne_tpu/data/geo.py``.

The reference's picking stage classifies every hypocentre as onshore (inside
the Japan land polygon) or offshore and stores the result as an
``is_onshore`` dataset (its ``scripts/preprocessing/03_picking_save2training.py``).
It fetches the exact polygon with OSMnx and tests points with shapely.

Here, dependency-free by default:
- where osmnx and shapely are importable (and the network answers), the
  reference's exact path is taken;
- otherwise an embedded coarse coastline of the main Japanese islands
  (Hokkaido, Honshu, Shikoku, Kyushu, Okinawa; about 60 vertices) is tested
  with a vectorized even-odd ray casting, accurate to a few tens of km along
  the coast, which resolves onshore from offshore for hypocentres (offshore
  events sit well outside the coastline).  Small islands (Sado, Awaji, the
  Izu chain, ...) are not in the coarse set and classify as offshore.
"""

from __future__ import annotations

import logging
from functools import lru_cache

import numpy as np

logger = logging.getLogger("tqdne_tpu_torch")

# (lon, lat) rings, not closed (closure is applied by points_in_polygon).
# Hand-digitized coarse outlines; vertex order follows the coastline.
_HOKKAIDO = np.array([
    (140.10, 41.42), (139.85, 42.10), (140.35, 43.25), (141.30, 43.15),
    (141.65, 44.50), (141.68, 45.42), (142.70, 45.10), (144.30, 44.10),
    (145.35, 44.35), (145.80, 43.38), (144.40, 42.95), (143.25, 41.93),
    (141.70, 42.60), (141.00, 42.30),
])

_HONSHU = np.array([
    (140.90, 41.55), (141.50, 41.20), (141.55, 40.50), (141.95, 39.60),
    (141.60, 38.90), (141.05, 38.30), (140.95, 37.20), (140.60, 36.30),
    (140.85, 35.72), (140.40, 35.10), (139.95, 34.90), (139.45, 35.20),
    (139.10, 34.85), (138.85, 34.60), (138.75, 35.00), (138.20, 34.60),
    (137.00, 34.55), (136.55, 34.50), (136.30, 34.00), (135.75, 33.43),
    (135.10, 33.85), (135.15, 34.25), (134.65, 34.60), (133.90, 34.55),
    (133.00, 34.35), (132.25, 34.25), (131.50, 33.95), (130.95, 33.95),
    (131.40, 34.45), (132.60, 35.25), (133.20, 35.55), (134.30, 35.55),
    (135.20, 35.75), (135.80, 35.50), (136.05, 35.65), (136.10, 36.20),
    (136.60, 36.60), (136.90, 37.30), (137.35, 37.53), (137.20, 36.85),
    (137.90, 37.00), (139.00, 37.90), (139.45, 38.30), (139.80, 38.90),
    (140.05, 39.72), (139.90, 40.40), (140.30, 40.90), (140.35, 41.25),
])

_SHIKOKU = np.array([
    (132.95, 32.72), (132.35, 33.35), (132.70, 34.00), (133.60, 34.25),
    (134.05, 34.35), (134.75, 34.20), (134.63, 33.83), (134.18, 33.25),
    (133.30, 33.35),
])

_KYUSHU = np.array([
    (130.95, 33.95), (131.70, 33.35), (131.70, 32.50), (131.50, 31.90),
    (131.35, 31.36), (130.66, 30.99), (130.30, 31.27), (130.20, 31.80),
    (129.75, 32.57), (129.55, 33.35), (130.20, 33.60), (130.40, 33.90),
])

_OKINAWA = np.array([
    (127.60, 26.00), (127.95, 26.35), (128.33, 26.75), (128.15, 26.90),
    (127.80, 26.45), (127.55, 26.15),
])

JAPAN_POLYGONS = (_HOKKAIDO, _HONSHU, _SHIKOKU, _KYUSHU, _OKINAWA)


def points_in_polygon(lon, lat, polygon) -> np.ndarray:
    """Vectorized even-odd (ray casting) point-in-polygon test.

    Parameters: lon/lat arrays of query points; polygon is a (V, 2) array
    of (lon, lat) vertices (the closing edge is implicit).
    Returns a bool array; points exactly on an edge are implementation-
    defined (irrelevant at hypocenter precision).
    """
    lon = np.atleast_1d(np.asarray(lon, np.float64))
    lat = np.atleast_1d(np.asarray(lat, np.float64))
    poly = np.asarray(polygon, np.float64)
    x1, y1 = poly[:, 0], poly[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)

    py = lat[None, :]
    crosses = (y1[:, None] > py) != (y2[:, None] > py)  # edge spans the ray's y
    dy = np.where(y2 == y1, 1.0, y2 - y1)  # horizontal edges never cross
    xint = x1[:, None] + (py - y1[:, None]) * ((x2 - x1) / dy)[:, None]
    hits = crosses & (lon[None, :] < xint)
    return hits.sum(axis=0) % 2 == 1


@lru_cache(maxsize=1)
def _exact_japan_polygon():
    """OSMnx/shapely path (reference-exact); None when unavailable.
    Cached: classify_onshore is called per record in the preprocessing
    loop and the geocode fetch/parse must happen at most once."""
    try:  # pragma: no cover - exercised only in full envs with network
        import osmnx as ox

        gdf = ox.geocode_to_gdf("Japan")
        if gdf.empty:
            return None
        return gdf.iloc[0].geometry
    except Exception:
        return None


def classify_onshore(lat, lon, method: str = "auto") -> np.ndarray:
    """1 where the hypocenter lies on land (Japan), 0 offshore.

    method: "auto" tries the OSMnx exact polygon, then falls back to the
    embedded coarse coastline; "coarse" forces the embedded polygons.
    Matches the reference's int encoding (03_picking:220-224).
    """
    lat = np.atleast_1d(np.asarray(lat, np.float64))
    lon = np.atleast_1d(np.asarray(lon, np.float64))

    if method == "auto":
        poly = _exact_japan_polygon()
        if poly is not None:  # pragma: no cover
            from shapely.geometry import Point

            return np.array([1 if poly.contains(Point(x, y)) else 0
                             for y, x in zip(lat, lon)], np.int64)
        logger.debug("osmnx unavailable; using embedded coarse Japan coastline")

    inside = np.zeros(lat.shape, bool)
    for ring in JAPAN_POLYGONS:
        inside |= points_in_polygon(lon, lat, ring)
    return inside.astype(np.int64)
