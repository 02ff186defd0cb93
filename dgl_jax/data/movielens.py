"""MovieLens data pipeline for GCMC.

Equivalent of the reference's ``gcmc_dgl/data.py`` (P1): builds
the heterogeneous bipartite rating multigraph (one forward + one reverse
edge type per rating value, ``data.py:245-263``), symmetric degree norms
``ci``/``cj`` (``:268-297``), the homogeneous user→movie "decoder graph" of
rated pairs (``:301-306``), and train/valid/test enc/dec six-packs
(``:196-209``).

Reads the real MovieLens ``u.data`` tab-separated format when present under
the data root (``ml-100k/u.data``: user, item, rating, timestamp); otherwise
generates a synthetic rating table with ml-100k's shape (943 users × 1682
movies × 100k ratings 1..5, user-bias + item-bias + noise structure so the
rating signal is learnable).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax.numpy as jnp

from ..graph.graph import Graph, from_edges
from ..graph.hetero import HeteroGraph
from .loaders import data_root

__all__ = ["MovieLensData", "load_movielens"]

ML_SHAPES = {
    "ml-100k": (943, 1682, 100_000),
    "ml-1m": (6040, 3706, 1_000_209),
    "ml-10m": (69878, 10677, 10_000_054),
}


@dataclasses.dataclass
class MovieLensData:
    rating_vals: List[int]
    num_users: int
    num_movies: int
    user_feat: np.ndarray
    movie_feat: np.ndarray
    # per split: (enc_graph, dec_graph, edge ratings (labels))
    train: Tuple[HeteroGraph, Graph, np.ndarray]
    valid: Tuple[HeteroGraph, Graph, np.ndarray]
    test: Tuple[HeteroGraph, Graph, np.ndarray]
    norms: Dict[str, Tuple[jnp.ndarray, jnp.ndarray]]  # ntype -> (ci, cj)
    synthetic: bool = True


def _hash_embedding(text: str, dim: int = 300) -> np.ndarray:
    """Deterministic per-token embedding averaged over the title's tokens —
    stands in for the reference's GloVe-840B average (``gcmc_dgl/
    data.py:517-531``) in this zero-egress environment. Each token maps to a
    fixed unit-variance vector seeded by a stable hash of its lowercase
    form, so shared title words still produce correlated features."""
    import zlib

    toks = [t for t in "".join(c if c.isalnum() else " " for c in text.lower()).split() if t]
    if not toks:
        return np.zeros(dim, np.float32)
    vecs = [
        np.random.default_rng(zlib.crc32(t.encode())).standard_normal(dim)
        for t in toks
    ]
    return np.mean(vecs, axis=0).astype(np.float32)


def _load_user_features(dir_: str, n_u: int) -> Optional[np.ndarray]:
    """Parse ``u.user`` (``id|age|gender|occupation|zip``) into the
    reference's user feature layout: ``[age/50, is_female,
    occupation-one-hot]`` (``gcmc_dgl/data.py:415-431``)."""
    path = os.path.join(dir_, "u.user")
    if not os.path.exists(path):
        return None
    rows = []
    with open(path, encoding="latin1") as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                rows.append(line.split("|"))
    ids = np.array([int(r[0]) for r in rows]) - 1
    ages = np.array([float(r[1]) for r in rows], np.float32)
    female = np.array([1.0 if r[2] == "F" else 0.0 for r in rows], np.float32)
    occs = sorted({r[3] for r in rows})
    occ_map = {o: i for i, o in enumerate(occs)}
    one_hot = np.zeros((len(rows), len(occs)), np.float32)
    one_hot[np.arange(len(rows)), [occ_map[r[3]] for r in rows]] = 1.0
    feat = np.zeros((n_u, 2 + len(occs)), np.float32)
    feat[ids] = np.concatenate(
        [ages[:, None] / 50.0, female[:, None], one_hot], axis=1
    )
    return feat


def _load_movie_features(dir_: str, n_m: int) -> Optional[np.ndarray]:
    """Parse ``u.item`` (``id|title|release_date|video_date|url|<19 genre
    flags>``) into the reference layout: ``[title-embedding(300),
    (year-1950)/100, genres]`` (``gcmc_dgl/data.py:492-537``), with the
    GloVe average replaced by :func:`_hash_embedding`."""
    import re

    path = os.path.join(dir_, "u.item")
    if not os.path.exists(path):
        return None
    year_re = re.compile(r"(.+)\s*\((\d+)\)")
    titles, years, genres, ids = [], [], [], []
    with open(path, encoding="latin1") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 6:
                continue
            ids.append(int(parts[0]) - 1)
            m = year_re.match(parts[1])
            if m:
                titles.append(m.group(1))
                years.append(float(m.group(2)))
            else:
                titles.append(parts[1])
                years.append(1950.0)
            genres.append([float(g) for g in parts[5:]])
    n_genres = max(len(g) for g in genres)
    feat = np.zeros((n_m, 300 + 1 + n_genres), np.float32)
    for i, mid in enumerate(ids):
        g = np.zeros(n_genres, np.float32)
        g[: len(genres[i])] = genres[i]
        feat[mid] = np.concatenate(
            [_hash_embedding(titles[i]), [(years[i] - 1950.0) / 100.0], g]
        )
    return feat


def _read_or_generate(name: str, seed: int):
    path = os.path.join(data_root(), name, "u.data")
    if os.path.exists(path):
        raw = np.loadtxt(path, dtype=np.int64)
        users, movies, ratings = raw[:, 0] - 1, raw[:, 1] - 1, raw[:, 2]
        n_u, n_m = int(users.max()) + 1, int(movies.max()) + 1
        return users, movies, ratings, n_u, n_m, False
    if name not in ML_SHAPES:
        raise ValueError(f"unknown MovieLens dataset {name!r}; known: {sorted(ML_SHAPES)}")
    n_u, n_m, n_r = ML_SHAPES[name]
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_u, n_r)
    movies = (rng.zipf(1.4, n_r) - 1) % n_m  # popularity skew
    u_bias = rng.normal(0, 0.8, n_u)
    m_bias = rng.normal(0, 0.8, n_m)
    score = 3.0 + u_bias[users] + m_bias[movies] + rng.normal(0, 0.7, n_r)
    ratings = np.clip(np.round(score), 1, 5).astype(np.int64)
    return users, movies, ratings, n_u, n_m, True


def _build_enc_graph(
    users, movies, ratings, rating_vals, n_u, n_m
) -> HeteroGraph:
    rels = {}
    for r in rating_vals:
        m = ratings == r
        rels[("user", str(r), "movie")] = from_edges(
            users[m], movies[m], n_u, n_m
        )
        rels[("movie", f"rev-{r}", "user")] = from_edges(
            movies[m], users[m], n_m, n_u
        )
    return HeteroGraph(rels, {"user": n_u, "movie": n_m})


def load_movielens(
    name: str = "ml-100k", seed: int = 0, test_frac: float = 0.1, valid_frac: float = 0.05
) -> MovieLensData:
    users, movies, ratings, n_u, n_m, synth = _read_or_generate(name, seed)
    rating_vals = sorted(np.unique(ratings).tolist())
    rng = np.random.default_rng(seed)
    n = len(users)
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    n_valid = int(n * valid_frac)
    splits = {
        "test": perm[:n_test],
        "valid": perm[n_test : n_test + n_valid],
        "train": perm[n_test + n_valid :],
    }

    # norms from the TRAIN rating graph (reference :268-297): 1/sqrt(deg)
    tr = splits["train"]
    u_deg = np.bincount(users[tr], minlength=n_u).astype(np.float32)
    m_deg = np.bincount(movies[tr], minlength=n_m).astype(np.float32)
    ci_u = (1.0 / np.sqrt(np.maximum(u_deg, 1)))[:, None]
    ci_m = (1.0 / np.sqrt(np.maximum(m_deg, 1)))[:, None]
    norms = {
        "user": (jnp.asarray(ci_u), jnp.asarray(ci_u)),
        "movie": (jnp.asarray(ci_m), jnp.asarray(ci_m)),
    }

    def pack(idx, enc_idx):
        enc = _build_enc_graph(
            users[enc_idx], movies[enc_idx], ratings[enc_idx], rating_vals, n_u, n_m
        )
        dec = from_edges(users[idx], movies[idx], n_u, n_m)
        # labels in canonical (dst-sorted) dec-graph edge order
        lab = np.zeros(dec.num_edges_padded, dtype=np.int64)
        eid = np.asarray(dec.eid)[: dec.num_edges]
        r_classes = np.searchsorted(rating_vals, ratings[idx])
        lab[: dec.num_edges] = r_classes[eid]
        return enc, dec, lab

    train = pack(splits["train"], splits["train"])
    valid = pack(splits["valid"], splits["train"])
    test = pack(splits["test"], np.concatenate([splits["train"], splits["valid"]]))

    # features: demographics + title embeddings parsed from u.user/u.item
    # when present (reference semantics, data.py:415-537); random stand-ins
    # with the real dims otherwise
    user_feat = movie_feat = None
    if not synth:
        ml_dir = os.path.join(data_root(), name)
        user_feat = _load_user_features(ml_dir, n_u)
        movie_feat = _load_movie_features(ml_dir, n_m)
    if user_feat is None:
        user_feat = rng.standard_normal((n_u, 23)).astype(np.float32)
    if movie_feat is None:
        movie_feat = rng.standard_normal((n_m, 320)).astype(np.float32)

    return MovieLensData(
        rating_vals=rating_vals,
        num_users=n_u,
        num_movies=n_m,
        user_feat=user_feat,
        movie_feat=movie_feat,
        train=train,
        valid=valid,
        test=test,
        norms=norms,
        synthetic=synth,
    )
