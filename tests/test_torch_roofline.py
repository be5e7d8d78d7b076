"""The roofline's analytics (``repro_torch.launch.roofline``) against the
reference's, exactly (``==``): ``projected_memory_bytes`` for every arch,
supported shape and chip count; ``model_flops``; ``analyze``,
``diagnosis``, ``table`` and ``fmt_table`` over synthetic dry-run records
with the reference module's constants patched to the card's (nothing
edited on disk).  The reference's ``fits_16gb`` (a hard-coded 16e9) is the
port's ``fits_80gb`` (``hbm < HBM_BYTES``), so that one key is held to its
own rule and the reference's tables are fed the port's verdict."""

import json

import numpy as np
import pytest

from repro import configs as jc
from repro.configs import shapes as jshapes
from repro.launch import roofline as jr
from repro_torch import configs as tc
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import roofline as tr


def test_constants_are_the_h100s():
    assert (tr.PEAK_FLOPS, tr.HBM_BW, tr.LINK_BW, tr.HBM_BYTES) == \
        (989e12, 3.35e12, 450e9, 80e9)


@pytest.mark.parametrize("arch", jc.ALL_IDS)
def test_projected_memory_bytes_match(arch):
    j_cfg, t_cfg = jc.get_config(arch), tc.get_config(arch)
    n = 0
    for name, j_shape in jshapes.SHAPES.items():
        if not jshapes.cell_supported(j_cfg, j_shape)[0]:
            continue
        for chips in (256, 512):
            assert tr.projected_memory_bytes(
                t_cfg, tshapes.SHAPES[name], chips) == \
                jr.projected_memory_bytes(j_cfg, j_shape, chips)
            n += 1
    assert n >= 6


def records(seed: int = 0) -> list[dict]:
    """Synthetic dry-run records with the keys ``launch/dryrun.py`` writes:
    every arch x shape on both meshes, some calibrated, some skipped, a
    variant, and an arch the configs do not know."""
    rng = np.random.default_rng(seed)
    out = []
    for arch in jc.ALL_IDS + ["not-an-arch"]:
        cfg = jc.get_config(arch if arch in jc.ALL_IDS else "gemma3-1b")
        for name, shape in jshapes.SHAPES.items():
            for mesh, chips in (("16x16", 256), ("2x16x16", 512)):
                coll = {"total": float(rng.uniform(0, 5e10)),
                        "traffic_total": float(rng.uniform(0, 9e10))}
                rec = {"arch": arch, "shape": name, "kind": shape.kind,
                       "mesh": mesh, "status": "ok", "n_devices": chips,
                       "flops_per_device": float(rng.uniform(0, 3e15)),
                       "bytes_per_device": float(rng.uniform(0, 5e12)),
                       "collective_bytes_per_device": coll,
                       "memory": {"argument_size": float(rng.uniform(0, 6e10)),
                                  "output_size": float(rng.uniform(0, 2e10)),
                                  "temp_size": float(rng.uniform(0, 4e10))},
                       "param_count": cfg.param_count(),
                       "active_param_count": cfg.active_param_count(),
                       "compile_s": round(float(rng.uniform(1, 99)), 1)}
                if rng.uniform() < 0.1:
                    rec["status"] = "skip"
                if rng.uniform() < 0.3:
                    rec["variant"] = "opt_banded"
                if rng.uniform() < 0.5:
                    rec["calibrated"] = {
                        "flops_per_device": float(rng.uniform(0, 3e15)),
                        "bytes_per_device": float(rng.uniform(0, 5e12)),
                        "collective_bytes_per_device":
                            float(rng.uniform(0, 5e10)),
                        "collective_traffic_per_device":
                            float(rng.uniform(0, 9e10))}
                if rng.uniform() < 0.05:
                    rec["flops_per_device"] = None
                    rec.pop("calibrated", None)
                out.append(rec)
    return out


@pytest.fixture
def card_reference(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jr, name, getattr(tr, name))
    return jr


def as_reference(row: dict) -> dict:
    """A port row with ``fits_80gb`` under the reference's key."""
    out = dict(row)
    out["fits_16gb"] = out.pop("fits_80gb")
    return out


def test_model_flops_and_analyze_match(card_reference):
    recs = [r for r in records() if r["status"] == "ok"]
    fits = 0
    for rec in recs:
        assert tr.model_flops(rec) == jr.model_flops(rec)
        got, want = tr.analyze(rec), card_reference.analyze(rec)
        hbm = got["hbm_bytes_per_device"]
        assert got.pop("fits_80gb") == (hbm < 80e9)
        fits += 16e9 <= hbm < 80e9
        want.pop("fits_16gb")
        assert got == want
        assert tr.diagnosis(tr.analyze(rec)) == jr.diagnosis(want)
    assert fits       # some records fit 80 GB and not 16 GB


def test_table_and_fmt_table_match(card_reference, tmp_path):
    for i, rec in enumerate(records(1)):
        with open(tmp_path / f"{i:04d}.json", "w") as f:
            json.dump(rec, f)
    with open(tmp_path / "notes.txt", "w") as f:
        f.write("not a record")
    assert tr.load_all(str(tmp_path)) == jr.load_all(str(tmp_path))
    for mesh in ("16x16", "2x16x16"):
        for variant in ("baseline", "opt_banded"):
            got = tr.table(str(tmp_path), mesh, variant)
            want = card_reference.table(str(tmp_path), mesh, variant)
            assert got and [as_reference(r) | {"fits_16gb": w["fits_16gb"]}
                            for r, w in zip(got, want)] == want
            rows = [as_reference(r) for r in got]
            for md in (False, True):
                assert tr.fmt_table(got, markdown=md) == jr.fmt_table(
                    rows, markdown=md).replace("fits 16GB", "fits 80GB")
