"""The port's ASR-proxy gate (``tools/torch_asr_proxy.py``) against the JAX
package's (``tools/asr_proxy.py``), on the CPU.

The synthetic clips and class patterns (a numpy copy of
``jax.image.resize(..., "cubic")``) agree with the JAX tool's to 1e-6 (float32
sums in another order); the labels exactly. The statistics are numpy in
both tools and must agree exactly on the same flip matrices: fooling rates,
prediction agreement, flip overlap, the clip bootstrap and the gate with its
self-test. One end-to-end run of the tool on the CPU at its smallest size
writes the report's schema; the full run, whose figures PERF.md quotes, is
made on the card.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVERS = ("f32_chunk", "f32_ulp", "bf16", "multigrid", "multigrid_cs12", "f16_egress")


@pytest.fixture(scope="module")
def tools():
    """(JAX tool, port tool) modules."""
    sys.path.insert(0, REPO)
    try:
        import tools.asr_proxy as jproxy
        import tools.torch_asr_proxy as pproxy
    finally:
        sys.path.remove(REPO)
    return jproxy, pproxy


def test_synthetic_task_matches_the_jax_tool(tools):
    jproxy, pproxy = tools
    np.testing.assert_allclose(pproxy.smooth_clips(3, 4, 16, seed=5),
                               np.asarray(jproxy.smooth_clips(3, 4, 16, seed=5)), atol=1e-6)
    patterns = pproxy.class_patterns(t=4, hw=16)
    np.testing.assert_allclose(patterns, np.asarray(jproxy.class_patterns(t=4, hw=16)),
                               atol=1e-6)
    clips, labels = pproxy.labeled_clips(12, 4, 16, seed=2, patterns=patterns)
    jclips, jlabels = jproxy.labeled_clips(12, 4, 16, seed=2,
                                           patterns=jproxy.class_patterns(t=4, hw=16))
    np.testing.assert_array_equal(labels, np.asarray(jlabels))
    np.testing.assert_allclose(clips, np.asarray(jclips), atol=1e-6)
    assert clips.dtype == np.float32 and 0 <= clips.min() and clips.max() <= 1


def test_statistics_match_the_jax_tool(tools):
    jproxy, pproxy = tools
    rng = np.random.RandomState(0)
    names = [f"v{i}" for i in range(3)]
    clean = {n: rng.randint(0, 5, 40) for n in names}
    sets = {tag: {n: np.where(rng.rand(40) < p, rng.randint(0, 5, 40), clean[n]) for n in names}
            for tag, p in (("f32", 0.5), ("lever", 0.35), ("noise", 0.1))}
    assert pproxy.fooling_rates(names, clean, sets["lever"]) == \
        jproxy.fooling_rates(dict.fromkeys(names), clean, None, adv_preds=sets["lever"])
    assert pproxy.pred_agreement(sets["lever"], sets["f32"]) == \
        jproxy.pred_agreement(sets["lever"], sets["f32"])
    assert pproxy.flip_overlap(clean, sets["f32"], sets["lever"]) == \
        jproxy.flip_overlap(clean, sets["f32"], sets["lever"])
    flips = {tag: pproxy.flip_matrix(clean, s) for tag, s in sets.items()}
    for tag, s in sets.items():
        np.testing.assert_array_equal(flips[tag], jproxy.flip_matrix(clean, s))
    stat = lambda idx: flips["f32"][:, idx].mean()  # noqa: E731
    assert pproxy.bootstrap_ci(stat, 40, n_boot=200) == jproxy.bootstrap_ci(stat, 40, n_boot=200)
    for lever in ("lever", "noise"):
        assert pproxy.gate_lever(flips["f32"], flips[lever], flips["noise"], n_boot=200) == \
            jproxy.gate_lever(flips["f32"], flips[lever], flips["noise"], n_boot=200)


def test_gate_self_test_fails_where_it_should(tools):
    """Noise taken as a lever and an attack that flips nothing fail the gate;
    a lever that keeps f32's flips passes."""
    _, pproxy = tools
    rng = np.random.RandomState(1)
    f32 = rng.rand(6, 60) < 0.4
    noise = rng.rand(6, 60) < 0.05
    st = pproxy.self_test(f32, noise, retain=0.5, n_boot=200)
    assert not st["noise_as_lever"]["passes"] and not st["identity_as_lever"]["passes"]
    assert st["identity_as_lever"]["fails_significant"]
    assert pproxy.gate_lever(f32, f32, noise, n_boot=200)["passes"]


def test_end_to_end_on_the_cpu_at_the_smallest_size(tools, tmp_path):
    _, pproxy = tools
    out = tmp_path / "asr.json"
    got = pproxy.main(["--device", "cpu", "--clips", "4", "--steps", "2", "--frames", "4",
                       "--train_steps", "1", "--train_clips", "4", "--boot", "10",
                       "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))
    assert got["device"] == {"device": "cpu"}
    assert set(got["gates"]) == set(LEVERS) | {"gate_meta"}
    assert set(got["results"]) == {"f32", "noise_control"} | set(LEVERS)
    meta = got["gates"]["gate_meta"]
    assert meta["n_clips"] == 4 and meta["n_pairs"] == 24
    assert isinstance(meta["gate_can_fail"], bool) and "noise_as_lever" in meta["self_test"]
    # the tiny AlexNet has no depth-3 tap at the coarse 16²
    assert got["protocol"]["coarse_phase_sat_out"] == {"multigrid": ["alexnet"],
                                                       "multigrid_cs12": ["alexnet"]}
    for lever in LEVERS:
        assert isinstance(got["gates"][lever]["passes"], bool)
