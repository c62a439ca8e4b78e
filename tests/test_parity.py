"""Real-data readiness kit tests (hypergef.data.parity).

The reference's real-data story is its tier-1 dataset test
(``test/hgnn_test.py:65-92``) plus trained accuracies; this environment
has no real AllSet bytes, so the kit must (a) pass cleanly on the
committed format fixtures, (b) turn strict the moment unmarked
(real-looking) data appears, and (c) record committable fingerprints.
"""

import json
import os
import shutil

import pytest

from hypergef.data.datasets import EXISTING_DATASETS
from hypergef.data import parity

FIXTURE_ROOT = os.path.join(os.path.dirname(__file__), "fixtures", "data")


@pytest.mark.parametrize("name", sorted(EXISTING_DATASETS))
def test_validate_passes_on_fixtures(name):
    results = parity.validate(name, root=FIXTURE_ROOT)
    by = {r.name: r for r in results}
    assert by["format"].status == "PASS", by["format"].detail
    # fixtures carry the FIXTURE marker → real-shape check must SKIP
    assert by["shape"].status == "SKIP", by["shape"].detail
    assert by["oracle"].status == "PASS", by["oracle"].detail
    assert not [r for r in results if r.status == "FAIL"]


def test_expected_real_covers_all_13():
    assert set(EXPECTED := parity.EXPECTED_REAL) == set(EXISTING_DATASETS)
    for name, exp in EXPECTED.items():
        assert exp["num_nodes"] > 0 and exp["num_edges"] > 0


def test_shape_check_strict_without_marker(tmp_path):
    """Unmarked data that claims to be a real dataset but has the wrong
    shape must FAIL the shape check — that is the drop-in guarantee."""
    src = os.path.join(FIXTURE_ROOT, "zoo")
    dst = tmp_path / "zoo"
    shutil.copytree(src, dst)
    marker = dst / "FIXTURE"
    if marker.exists():
        marker.unlink()
    # remove the npz cache so the loader re-reads raw files
    for f in dst.glob("processed*.npz"):
        f.unlink()
    results = parity.validate("zoo", root=str(tmp_path))
    by = {r.name: r for r in results}
    assert by["shape"].status == "FAIL"
    assert "expected" in by["shape"].detail


def test_fingerprint_and_record(tmp_path):
    fp = parity.fingerprint(FIXTURE_ROOT, "zoo")
    assert "zoo.content" in fp and "zoo.edges" in fp
    for meta in fp.values():
        assert len(meta["sha256"]) == 64 and meta["bytes"] > 0
    rec_path = str(tmp_path / "rec.json")
    results = parity.validate("zoo", root=FIXTURE_ROOT, record=rec_path)
    assert any(r.name == "record" and r.status == "PASS" for r in results)
    rec = json.load(open(rec_path))
    assert rec["dataset"] == "zoo"
    assert rec["files"] == fp
    assert rec["loaded"]["num_nodes"] > 0
