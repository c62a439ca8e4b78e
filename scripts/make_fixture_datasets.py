"""Generate deterministic real-shaped fixture datasets — ALL 13 names
the reference's tier-1 test runs (``test/hgnn_test.py:65-92``,
``dataloader.py:20-58``), in their real raw formats.

The environment has no network egress, so the reference's raw datasets
cannot be fetched; these committed fixtures exercise every loader
end-to-end with learnable (homophilic) structure so accuracy assertions
are meaningful.  Output: tests/fixtures/data/.

Deterministic: fixed seeds, stable file ordering.  Re-run to regenerate.
"""

import os
import pickle

import numpy as np
import scipy.sparse as sp

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "fixtures", "data")


def homophilic_edges(labels, num_edges, avg_size, noise, rng):
    """Hyperedges drawn mostly within one class (AllSet-benchmark-like
    community structure) — models must beat chance on these."""
    n_classes = labels.max() + 1
    by_class = [np.nonzero(labels == c)[0] for c in range(n_classes)]
    edge_lists = []
    for _ in range(num_edges):
        c = rng.integers(0, n_classes)
        pool = by_class[c]
        k = max(int(rng.poisson(avg_size)), 2)
        k = min(k, pool.size)
        members = rng.choice(pool, size=k, replace=False)
        flip = rng.random(k) < noise
        members[flip] = rng.integers(0, labels.size, size=int(flip.sum()))
        edge_lists.append(sorted(set(int(m) for m in members)))
    return edge_lists


def make_le(name, seed, n=120, n_classes=4, n_feat=16, n_edges=70,
            avg=5.0):
    """LE format: <name>.content (id feat... label) + <name>.edges —
    ModelNet40 / NTU2012 / zoo / 20newsW100 / Mushroom family."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    centers = rng.normal(size=(n_classes, n_feat))
    feats = centers[labels] + 0.4 * rng.normal(size=(n, n_feat))
    edge_lists = homophilic_edges(labels, n_edges, avg, 0.1, rng)
    d = os.path.join(OUT, name, "raw")
    os.makedirs(d, exist_ok=True)
    ids = 1000 + np.arange(n)  # non-contiguous raw ids (real LE files are)
    with open(os.path.join(d, f"{name}.content"), "w") as f:
        for i in range(n):
            fv = " ".join(f"{v:.4f}" for v in feats[i])
            f.write(f"{ids[i]} {fv} class{labels[i]}\n")
    with open(os.path.join(d, f"{name}.edges"), "w") as f:
        for members in edge_lists:
            f.write(" ".join(str(ids[m]) for m in members) + "\n")


def make_citation(name, seed, n=150, n_classes=3, n_feat=24, n_edges=90,
                  avg=4.0):
    """AllSet citation pickles: features/labels/hypergraph — cora /
    citeseer / pubmed cocitation + coauthor_cora / coauthor_dblp."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    base = np.zeros((n, n_feat), dtype=np.float32)
    for i in range(n):
        on = rng.choice(n_feat // n_classes, size=3, replace=False)
        base[i, labels[i] * (n_feat // n_classes) + on] = 1.0  # BoW-like
    feats = sp.csr_matrix(base)
    edge_lists = homophilic_edges(labels, n_edges, avg, 0.1, rng)
    d = os.path.join(OUT, name, "raw")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "features.pickle"), "wb") as f:
        pickle.dump(feats, f)
    with open(os.path.join(d, "labels.pickle"), "wb") as f:
        pickle.dump([int(x) for x in labels], f)
    with open(os.path.join(d, "hypergraph.pickle"), "wb") as f:
        pickle.dump({f"cite{i}": members
                     for i, members in enumerate(edge_lists)}, f)


def make_cornell(name, seed, n=140, n_classes=4, n_edges=80, avg=6.0):
    """Cornell format: node-labels-*.txt (1-based labels) +
    hyperedges-*.txt (1-based comma-separated member lists) —
    walmart-trips / house-committees."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    edge_lists = homophilic_edges(labels, n_edges, avg, 0.1, rng)
    d = os.path.join(OUT, name, "raw")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"node-labels-{name}.txt"), "w") as f:
        for l in labels:
            f.write(f"{l + 1}\n")
    with open(os.path.join(d, f"hyperedges-{name}.txt"), "w") as f:
        for members in edge_lists:
            f.write(",".join(str(m + 1) for m in members) + "\n")


def make_yelp(seed=44, n=130, n_edges=75):
    """The reference's EXACT yelp raw schema (load_dataset.py:199-303):
    latlong / locations (state_int, city_int) / name / business_stars /
    incidence_H CSVs, all 1-based where the reference is."""
    rng = np.random.default_rng(seed)
    n_states, n_cities = 3, 6
    stars = rng.integers(2, 11, size=n)  # 2..10 (stars*2 in the ref docs)
    # make labels learnable: map stars to 3 bands and build structure on
    # the bands (the loader trains on the shifted star labels directly)
    band = (stars - 2) // 3
    edge_lists = homophilic_edges(band.astype(np.int64), n_edges, 5.0,
                                  0.1, rng)
    d = os.path.join(OUT, "yelp", "raw", "yelp")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "yelp_restaurant_latlong.csv"), "w") as f:
        f.write("latitude,longitude\n")
        for b in band:  # band-correlated coordinates (learnable signal)
            f.write(f"{30.0 + 5*b + rng.normal()*0.8:.4f},"
                    f"{-100.0 + 7*b + rng.normal()*0.8:.4f}\n")
    with open(os.path.join(d, "yelp_restaurant_locations.csv"), "w") as f:
        f.write("city_int,state_int\n")
        for b in band:
            city = b * 2 + rng.integers(1, 3)  # 1..6, band-correlated
            f.write(f"{city},{b + 1}\n")
    words = ["taco", "sushi", "grill", "pizza", "pho", "bbq", "cafe",
             "diner", "noodle"]
    with open(os.path.join(d, "yelp_restaurant_name.csv"), "w") as f:
        f.write("name\n")
        for b in band:
            w = words[int(b) * 3 + int(rng.integers(0, 3))]
            f.write(f"the {w} place {int(rng.integers(0, 99))}\n")
    with open(os.path.join(d, "yelp_restaurant_business_stars.csv"),
              "w") as f:
        f.write("stars\n")
        for s in stars:
            f.write(f"{s}\n")
    with open(os.path.join(d, "yelp_restaurant_incidence_H.csv"), "w") as f:
        f.write("node,he\n")
        for e, members in enumerate(edge_lists):
            for m in members:
                f.write(f"{m + 1},{e + 1}\n")


ALL_13 = {
    # LE family (load_LE_dataset)
    "zoo": lambda: make_le("zoo", 11),
    "ModelNet40": lambda: make_le("ModelNet40", 12, n=160, n_classes=5,
                                  n_edges=90),
    "NTU2012": lambda: make_le("NTU2012", 13, n=140, n_classes=4,
                               n_edges=85),
    "20newsW100": lambda: make_le("20newsW100", 14, n=180, n_classes=4,
                                  n_edges=24, avg=30.0),  # few giant edges
    "Mushroom": lambda: make_le("Mushroom", 15, n=150, n_classes=2,
                                n_edges=30, avg=18.0),
    # citation pickles (load_citation_dataset)
    "cora": lambda: make_citation("cora", 22),
    "citeseer": lambda: make_citation("citeseer", 23, n=130, n_classes=4,
                                      n_feat=32),
    "pubmed": lambda: make_citation("pubmed", 24, n=200, n_classes=3,
                                    n_edges=110, avg=6.0),
    "coauthor_cora": lambda: make_citation("coauthor_cora", 25, n=140,
                                           n_classes=4, n_feat=28),
    "coauthor_dblp": lambda: make_citation("coauthor_dblp", 26, n=160,
                                           n_classes=4, n_feat=28,
                                           n_edges=100),
    # cornell txt (load_cornell_dataset)
    "walmart-trips": lambda: make_cornell("walmart-trips", 33),
    "house-committees": lambda: make_cornell("house-committees", 34,
                                             n=120, n_classes=3,
                                             n_edges=60, avg=8.0),
    # yelp CSVs (load_yelp_dataset, reference schema)
    "yelp": make_yelp,
}


if __name__ == "__main__":
    for name, fn in ALL_13.items():
        fn()
        # positive fixture marker: hypergef.data.parity skips the
        # real-shape/accuracy checks when this file is present, so the
        # same --validate-parity command is fixture-safe and real-strict
        with open(os.path.join(OUT, name, "FIXTURE"), "w") as f:
            f.write("synthetic fixture — not real AllSet raw data\n")
    total = 0
    for base, _, files in os.walk(OUT):
        for fn in files:
            total += os.path.getsize(os.path.join(base, fn))
    print(f"fixtures for {len(ALL_13)} datasets written to {OUT} "
          f"({total/1024:.1f} KiB)")
