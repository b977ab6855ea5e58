"""The generators: the same inputs from the same seed, and the
configuration's length list, longest template and total residues from
every seed."""

import json
import os

import numpy as np
import pytest

from aat_bench import cell as cells
from aat_bench import recipes
from aat_bench.reference import hmap_profile, sw_local

CONFIGS = ["swissprot_1of8", "scope40_1of16"]


def _config(name):
    with open(os.path.join(cells.BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def _lengths(cfg, inputs):
    if cfg["generator"] == "swissprot_fasta":
        return sorted(len(s) for _, s in sw_local.read_fasta(inputs["library"]))
    lib = inputs["library"]
    return sorted(len(hmap_profile.read_profile(os.path.join(lib, f))["aa"]) - 2
                  for f in os.listdir(lib))


@pytest.mark.parametrize("name", CONFIGS)
def test_length_list_is_the_configs(name):
    cfg = _config(name)
    lens = recipes.lengths(cfg)
    assert len(lens) == cfg["n_templates"]
    assert int(lens.max()) == cfg["longest_template"]
    assert int(lens.sum()) == cfg["total_residues"]


@pytest.mark.parametrize("name", CONFIGS)
def test_every_seed_keeps_the_lengths(name, tmp_path):
    cfg = _config(name)
    want = sorted(recipes.lengths(cfg).tolist())
    for seed in (3, 2**33 + 17):
        d = tmp_path / str(seed)
        d.mkdir()
        gen = cells.load_module("generators", cfg["generator"])
        inputs = gen.make(cfg, seed, str(d))
        assert inputs["residues"] == cfg["total_residues"]
        assert inputs["longest"] == cfg["longest_template"]
        assert _lengths(cfg, inputs) == want
        for q, path in inputs["queries"].items():
            assert os.path.exists(path), q


@pytest.mark.parametrize("name", CONFIGS)
def test_same_seed_same_inputs(name, tmp_path):
    cfg = _config(name)
    gen = cells.load_module("generators", cfg["generator"])
    cfg, _ = gen.small(cfg, {"queries": []})
    texts = []
    for run in ("a", "b", "c"):
        d = tmp_path / run
        d.mkdir()
        inputs = gen.make(cfg, 2**31 + 5 if run != "c" else 99, str(d))
        lib = inputs["library"]
        files = ([lib] if os.path.isfile(lib) else
                 [os.path.join(lib, f) for f in sorted(os.listdir(lib))])
        texts.append("".join(open(f).read() for f in files)
                     + "".join(open(p).read() for p in
                               inputs["queries"].values()))
    assert texts[0] == texts[1]
    assert texts[0] != texts[2]


def test_homologs_are_planted(tmp_path):
    """Each query's homologs score far above the random templates."""
    import torch
    cfg = _config("swissprot_1of8")
    gen = cells.load_module("generators", cfg["generator"])
    cfg, _ = gen.small(cfg, {"queries": []})
    inputs = gen.make(cfg, 7, str(tmp_path))
    alpha, table = sw_local.read_matrix(os.path.join(cells.ROOT,
                                                     cfg["submatrix"]))
    lib = [sw_local.encode(s, alpha)
           for _, s in sw_local.read_fasta(inputs["library"])]
    qlen = max(inputs["queries"])
    q = sw_local.encode(sw_local.read_fasta(inputs["queries"][qlen])[0][1],
                        alpha)
    sc = np.sort(sw_local.best_scores(q, lib, table, 12.0, 1.0,
                                      torch.device("cpu")))[::-1]
    per = cfg["homologs"]["per_query"]
    assert sc[per - 1] > 2 * sc[per + 2]
