"""The test-only cells: the benchmark's spec with a tiny configuration
(``configs/tiny.json``), a small predict mix (``traffic/predict_small.json``),
a kind of traffic of its own (``kinds/gram.py``, ``traffic/gram.json``), their
limits (``limits/``) and test-only metrics (``metrics/``), all added as files
and entries only. ``tiny.fit`` compares the numbers of ``limits/msd.fit.json``
(the MillionSongs cell kept for later), ``tiny.stages`` susy.fit's and
``tiny.predict`` susy.predict's; each reports the metrics of the cell
whose traffic it shares."""
import copy

from bench import harness

DIRS = (harness.HERE / "tests", harness.HERE)
CELLS = ("tiny.fit", "tiny.stages", "tiny.predict", "tiny.gram")
#: each test-only cell and the cell whose compared numbers it holds
MIRRORS = {"tiny.fit": "msd.fit", "tiny.stages": "susy.fit", "tiny.predict": "susy.predict"}
#: each test-only cell and the cell whose metrics it reports
LIKE = {"tiny.fit": "susy.fit", "tiny.stages": "susy.fit", "tiny.predict": "susy.predict"}


def spec() -> dict:
    s = copy.deepcopy(harness.load_spec())
    s["configs"].append({"name": "tiny", "source": "a test-only size",
                         "file": "bench/tests/configs/tiny.json", "reduced": [],
                         "why": "the loops' control flow on the CPU"})
    s["workloads"] += [
        {"name": "tiny.fit", "config": "tiny", "traffic": "fit", "chips": 1, "why": "test"},
        {"name": "tiny.stages", "config": "tiny", "traffic": "fit", "chips": 1, "why": "test"},
        {"name": "tiny.predict", "config": "tiny", "traffic": "predict_small", "chips": 1,
         "why": "test"},
        {"name": "tiny.gram", "config": "tiny", "traffic": "gram", "chips": 1, "why": "test"}]
    for m in s["end_to_end"] + s["per_layer"]:
        m["workloads"] = m.get("workloads", []) + [
            t for t, cell in LIKE.items() if cell in m.get("workloads", [])]
        if not m["workloads"]:
            del m["workloads"]
    s["end_to_end"].append({"name": "grams_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["tiny.gram"]})
    s["per_layer"] += [
        {"name": "fits_in_window", "unit": "fits", "better": "higher", "source": "host_clock",
         "layer": "fit driver", "moves": "fit_s", "workloads": ["tiny.fit"]},
        {"name": "grams_in_window", "unit": "grams", "better": "higher",
         "source": "host_clock", "layer": "kernels", "moves": "grams_per_s",
         "workloads": ["tiny.gram"]}]
    return s
