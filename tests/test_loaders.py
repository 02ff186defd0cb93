"""Fixture-file round-trip tests for the real-format dataset parsers.

The environment has no network egress, so the parsers in
``dgl_jax/data/loaders.py`` / ``movielens.py`` can't be exercised on the
actual downloads. These tests synthesize tiny on-disk fixtures in the EXACT
public layouts — Planetoid pickles, DGL ``reddit_*.npz``, OGB ``csv.gz``,
canonical npz, MovieLens ``u.data``/``u.user``/``u.item`` — and assert the
parsed graph/features/splits match the known ground truth. Reference format
sources: ``load_graph.py:14-41``, ``gcmc_dgl/data.py:109-209,415-537``.
"""

import gzip
import os
import pickle

import numpy as np
import pytest

from dgl_jax.data.loaders import load_node_dataset


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DGL_JAX_DATA_DIR", str(tmp_path))
    return str(tmp_path)


def test_canonical_npz(data_dir, rng):
    n, e = 20, 60
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    x = rng.standard_normal((n, 7)).astype(np.float32)
    y = rng.integers(0, 4, n)
    train = np.zeros(n, bool); train[:10] = True
    val = np.zeros(n, bool); val[10:15] = True
    test = np.zeros(n, bool); test[15:] = True
    np.savez(os.path.join(data_dir, "mini.npz"),
             src=src, dst=dst, x=x, y=y, train=train, val=val, test=test)
    d = load_node_dataset("mini")
    assert not d.synthetic
    np.testing.assert_array_equal(d.src, src)
    np.testing.assert_array_equal(d.dst, dst)
    np.testing.assert_allclose(d.features, x)
    np.testing.assert_array_equal(d.labels, y)
    np.testing.assert_array_equal(d.test_mask, test)
    assert d.num_classes == 4


def test_planetoid_fixture(data_dir, rng):
    """Exact ``ind.cora.*`` pickle layout, including the test-index
    permutation trick the parser must undo (rows of ``tx`` are stored in
    sorted-test-id order while ``test.index`` lists ids in file order)."""
    import scipy.sparse as sp

    n, n_train, n_test, d, c = 12, 4, 4, 5, 3
    target_feat = rng.standard_normal((n, d)).astype(np.float32)
    target_lab = rng.integers(0, c, n)
    test_idx = np.array([10, 8, 11, 9])  # file order (unsorted on purpose)
    test_sorted = np.sort(test_idx)
    base = n - n_test

    # invert the parser's permutation: after `feat[test_idx]=feat[test_sorted]`
    # node test_idx[i] holds tx[test_sorted[i]-base], so
    # tx[test_sorted[i]-base] must be target_feat[test_idx[i]]
    tx = np.zeros((n_test, d), np.float32)
    ty = np.zeros((n_test, c), np.float32)
    for i in range(n_test):
        tx[test_sorted[i] - base] = target_feat[test_idx[i]]
        ty[test_sorted[i] - base, target_lab[test_idx[i]]] = 1
    allx = target_feat[:base]
    ally = np.zeros((base, c), np.float32)
    ally[np.arange(base), target_lab[:base]] = 1

    graph = {0: [1, 2], 1: [0], 2: [0, 3], 3: [2], 10: [0], 8: [3]}
    root = os.path.join(data_dir, "cora")
    os.makedirs(root)

    def wr(suffix, obj):
        with open(os.path.join(root, f"ind.cora.{suffix}"), "wb") as f:
            if suffix == "test.index":
                f.write("\n".join(str(i) for i in obj).encode())
            else:
                pickle.dump(obj, f)

    wr("x", sp.csr_matrix(allx[:n_train]))
    wr("tx", sp.csr_matrix(tx))
    wr("allx", sp.csr_matrix(allx))
    wr("y", ally[:n_train])
    wr("ty", ty)
    wr("ally", ally)
    wr("graph", graph)
    wr("test.index", test_idx)

    dset = load_node_dataset("cora")
    assert not dset.synthetic
    assert dset.num_nodes == n
    np.testing.assert_allclose(dset.features, target_feat, rtol=1e-6)
    np.testing.assert_array_equal(dset.labels, target_lab)
    # masks: train = first len(y), test = test ids
    assert dset.train_mask[:n_train].all() and not dset.train_mask[n_train:].any()
    np.testing.assert_array_equal(np.where(dset.test_mask)[0], test_sorted)
    # edges round-trip (graph dict is adjacency lists)
    got = set(zip(dset.src.tolist(), dset.dst.tolist()))
    want = {(u, v) for u, vs in graph.items() for v in vs}
    assert got == want


def test_reddit_fixture(data_dir, rng):
    """DGL Reddit layout: ``reddit_data.npz`` (feature/label/node_types
    1=train 2=val 3=test) + ``reddit_graph.npz`` (scipy sparse adjacency)."""
    import scipy.sparse as sp

    n = 15
    feat = rng.standard_normal((n, 6)).astype(np.float32)
    lab = rng.integers(0, 5, n)
    types = np.array([1] * 8 + [2] * 3 + [3] * 4)
    src = rng.integers(0, n, 40)
    dst = rng.integers(0, n, 40)
    # symmetric adjacency (DGL reddit graph is bidirected)
    a = sp.coo_matrix((np.ones(80), (np.r_[src, dst], np.r_[dst, src])), shape=(n, n)).tocsr()
    a.sum_duplicates()
    root = os.path.join(data_dir, "reddit")
    os.makedirs(root)
    np.savez(os.path.join(root, "reddit_data.npz"),
             feature=feat, label=lab, node_types=types)
    sp.save_npz(os.path.join(root, "reddit_graph.npz"), a)

    d = load_node_dataset("reddit")
    assert not d.synthetic
    np.testing.assert_allclose(d.features, feat)
    np.testing.assert_array_equal(d.labels, lab)
    np.testing.assert_array_equal(d.train_mask, types == 1)
    np.testing.assert_array_equal(d.val_mask, types == 2)
    np.testing.assert_array_equal(d.test_mask, types == 3)
    coo = a.tocoo()
    assert set(zip(d.src.tolist(), d.dst.tolist())) == set(
        zip(coo.col.tolist(), coo.row.tolist())
    )


def test_ogb_node_fixture(data_dir, rng):
    """OGB node-prop raw layout: gzipped csvs + split index files."""
    n, e = 18, 50
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = rng.integers(0, 6, n)
    d = os.path.join(data_dir, "ogbn_arxiv")
    os.makedirs(os.path.join(d, "raw"))
    os.makedirs(os.path.join(d, "split", "time"))

    def wz(path, arr, fmt):
        with gzip.open(path, "wt") as f:
            np.savetxt(f, arr, delimiter=",", fmt=fmt)

    wz(os.path.join(d, "raw", "edge.csv.gz"), np.c_[src, dst], "%d")
    wz(os.path.join(d, "raw", "node-feat.csv.gz"), x, "%.6f")
    wz(os.path.join(d, "raw", "node-label.csv.gz"), y[:, None], "%d")
    tr, va, te = np.arange(0, 10), np.arange(10, 14), np.arange(14, 18)
    for part, idx in (("train", tr), ("valid", va), ("test", te)):
        wz(os.path.join(d, "split", "time", f"{part}.csv.gz"), idx, "%d")

    dset = load_node_dataset("ogbn-arxiv")
    assert not dset.synthetic
    np.testing.assert_array_equal(dset.src, src)
    np.testing.assert_array_equal(dset.dst, dst)
    np.testing.assert_allclose(dset.features, x, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(dset.labels, y)
    np.testing.assert_array_equal(np.where(dset.train_mask)[0], tr)
    np.testing.assert_array_equal(np.where(dset.val_mask)[0], va)
    np.testing.assert_array_equal(np.where(dset.test_mask)[0], te)


def test_movielens_fixture(data_dir, rng):
    """MovieLens ml-100k layout: tab-separated ``u.data`` ratings plus
    ``u.user`` demographics and ``u.item`` title/genre features
    (``gcmc_dgl/data.py:109-209,415-537`` semantics)."""
    from dgl_jax.data.movielens import load_movielens

    root = os.path.join(data_dir, "ml-100k")
    os.makedirs(root)
    n_u, n_m, n_r = 8, 6, 60
    users = rng.integers(0, n_u, n_r)
    movies = rng.integers(0, n_m, n_r)
    ratings = rng.integers(1, 6, n_r)
    with open(os.path.join(root, "u.data"), "w") as f:
        for u, m, r in zip(users, movies, ratings):
            f.write(f"{u + 1}\t{m + 1}\t{r}\t884182806\n")
    occs = ["artist", "doctor", "engineer"]
    with open(os.path.join(root, "u.user"), "w") as f:
        for u in range(n_u):
            f.write(f"{u + 1}|{20 + u}|{'F' if u % 2 else 'M'}|{occs[u % 3]}|55414\n")
    genres = np.eye(19, dtype=int)
    with open(os.path.join(root, "u.item"), "w", encoding="latin1") as f:
        for m in range(n_m):
            flags = "|".join(str(v) for v in genres[m % 19])
            f.write(
                f"{m + 1}|Toy Story {m} (199{m})|01-Jan-199{m}||http://x|{flags}\n"
            )

    d = load_movielens("ml-100k", seed=0)
    assert not d.synthetic
    assert d.num_users == n_u and d.num_movies == n_m
    # user features: [age/50, is_female, occupation one-hot(3)]
    assert d.user_feat.shape == (n_u, 5)
    np.testing.assert_allclose(d.user_feat[:, 0], (20 + np.arange(n_u)) / 50.0)
    np.testing.assert_allclose(d.user_feat[:, 1], np.arange(n_u) % 2)
    assert (d.user_feat[:, 2:].sum(axis=1) == 1).all()
    # movie features: [title-emb(300), (year-1950)/100, genres(19)]
    assert d.movie_feat.shape == (n_m, 320)
    np.testing.assert_allclose(
        d.movie_feat[:, 300], (1990 + np.arange(n_m) - 1950) / 100.0
    )
    np.testing.assert_array_equal(d.movie_feat[:, 301:], genres[np.arange(n_m) % 19])
    # same title words -> correlated embeddings ("Toy Story" shared tokens)
    emb = d.movie_feat[:, :300]
    cos = (emb[0] @ emb[1]) / (np.linalg.norm(emb[0]) * np.linalg.norm(emb[1]))
    assert cos > 0.5
    # ratings split across train/valid/test covers all edges exactly once
    n_edges = (
        d.train[1].num_edges + d.valid[1].num_edges + d.test[1].num_edges
    )
    assert n_edges == n_r
    # enc graph has one relation pair per observed rating value
    vals = sorted(set(ratings.tolist()))
    assert d.rating_vals == vals


def test_tu_fixture(data_dir, rng):
    """TU text layout (ENZYMES_A.txt etc., 1-based ids) -> per-graph
    structures with graph-local edges and continuous node attributes."""
    from dgl_jax.data.loaders import load_graph_dataset

    d = os.path.join(data_dir, "ENZYMES")
    os.makedirs(d)
    # 2 graphs: nodes 1-3 in g1 (triangle), 4-5 in g2 (single edge)
    np.savetxt(os.path.join(d, "ENZYMES_A.txt"),
               [[1, 2], [2, 3], [3, 1], [4, 5]], fmt="%d", delimiter=", ")
    np.savetxt(os.path.join(d, "ENZYMES_graph_indicator.txt"),
               [1, 1, 1, 2, 2], fmt="%d")
    np.savetxt(os.path.join(d, "ENZYMES_graph_labels.txt"), [2, 6], fmt="%d")
    attrs = rng.standard_normal((5, 18)).astype(np.float32)
    np.savetxt(os.path.join(d, "ENZYMES_node_attributes.txt"), attrs,
               delimiter=",", fmt="%.6f")
    data = load_graph_dataset("ENZYMES")
    assert not data.synthetic
    assert len(data.graphs) == 2
    s0, d0, n0 = data.graphs[0]
    np.testing.assert_array_equal(s0, [0, 1, 2])
    np.testing.assert_array_equal(d0, [1, 2, 0])
    assert n0 == 3
    s1, d1, n1 = data.graphs[1]
    np.testing.assert_array_equal(s1, [0])  # graph-local ids
    np.testing.assert_array_equal(d1, [1])
    assert n1 == 2
    np.testing.assert_allclose(data.node_feats[1], attrs[3:5], atol=1e-5)
    np.testing.assert_array_equal(data.labels, [0, 1])  # compacted
    assert data.splits is None  # TU -> reference random 80/10/10


def test_ogb_graph_fixture(data_dir, rng):
    """OGB graph-prop csv.gz layout -> graphs, int mol features, scaffold
    split indices."""
    from dgl_jax.data.loaders import load_graph_dataset

    d = os.path.join(data_dir, "ogbg_molhiv")
    raw = os.path.join(d, "raw")
    split = os.path.join(d, "split", "scaffold")
    os.makedirs(raw); os.makedirs(split)

    def wr(path, arr, fmt):
        with gzip.open(path, "wt") as f:
            np.savetxt(f, arr, fmt=fmt, delimiter=",")

    # 3 graphs: 2/3/2 nodes, 2/2/1 edges (graph-local ids)
    wr(os.path.join(raw, "edge.csv.gz"),
       [[0, 1], [1, 0], [0, 2], [2, 1], [1, 0]], "%d")
    wr(os.path.join(raw, "num-node-list.csv.gz"), [[2], [3], [2]], "%d")
    wr(os.path.join(raw, "num-edge-list.csv.gz"), [[2], [2], [1]], "%d")
    wr(os.path.join(raw, "graph-label.csv.gz"), [[0], [1], [0]], "%d")
    nf = rng.integers(0, 10, (7, 9))
    wr(os.path.join(raw, "node-feat.csv.gz"), nf, "%d")
    ef = rng.integers(0, 4, (5, 3))
    wr(os.path.join(raw, "edge-feat.csv.gz"), ef, "%d")
    wr(os.path.join(split, "train.csv.gz"), [[0]], "%d")
    wr(os.path.join(split, "valid.csv.gz"), [[1]], "%d")
    wr(os.path.join(split, "test.csv.gz"), [[2]], "%d")

    data = load_graph_dataset("ogbg-molhiv")
    assert not data.synthetic
    assert len(data.graphs) == 3
    s1, d1, n1 = data.graphs[1]
    np.testing.assert_array_equal(s1, [0, 2])
    np.testing.assert_array_equal(d1, [2, 1])
    assert n1 == 3
    assert data.node_feats[1].shape == (3, 9)
    assert data.node_feats[0].dtype == np.int32  # mol vocab ids
    np.testing.assert_array_equal(data.edge_feats[2], ef[4:5])
    np.testing.assert_array_equal(data.splits["valid"], [1])


def test_convert_tool_roundtrip(data_dir, rng, monkeypatch):
    """tools/convert_dataset.py caches a raw TU dir as canonical
    <name>_graphs.npz; the canonical file is then preferred and loads
    identically (including splits passthrough for OGB)."""
    import importlib
    import sys as _sys

    from dgl_jax.data.loaders import load_graph_dataset

    d = os.path.join(data_dir, "ENZYMES")
    os.makedirs(d)
    np.savetxt(os.path.join(d, "ENZYMES_A.txt"),
               [[1, 2], [2, 1], [3, 4]], fmt="%d", delimiter=", ")
    np.savetxt(os.path.join(d, "ENZYMES_graph_indicator.txt"),
               [1, 1, 2, 2], fmt="%d")
    np.savetxt(os.path.join(d, "ENZYMES_graph_labels.txt"), [1, 2], fmt="%d")
    np.savetxt(os.path.join(d, "ENZYMES_node_attributes.txt"),
               rng.standard_normal((4, 5)), delimiter=",", fmt="%.6f")
    before = load_graph_dataset("ENZYMES")

    sys_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    _sys.path.insert(0, sys_path)
    try:
        tool = importlib.import_module("convert_dataset")
    finally:
        _sys.path.remove(sys_path)
    monkeypatch.setattr(_sys, "argv",
                        ["convert_dataset.py", "graph", "ENZYMES"])
    tool.main()
    assert os.path.exists(os.path.join(data_dir, "ENZYMES_graphs.npz"))
    after = load_graph_dataset("ENZYMES")
    assert not after.synthetic
    assert len(after.graphs) == len(before.graphs)
    for (s0, d0, n0), (s1, d1, n1) in zip(before.graphs, after.graphs):
        np.testing.assert_array_equal(s0, s1)
        np.testing.assert_array_equal(d0, d1)
        assert n0 == n1
    np.testing.assert_allclose(
        np.concatenate(before.node_feats), np.concatenate(after.node_feats),
        atol=1e-6)
    np.testing.assert_array_equal(before.labels, after.labels)
