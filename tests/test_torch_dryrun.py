"""The port's dry run (``repro_torch.launch.dryrun``), in this process.

The counterpart of the reference's ``test_mini_dryrun_train_and_decode``
(``tests/test_distributed.py``), which lowers and compiles a train and a
decode cell on 8 forced host devices. That test is a known failure of
the reference (ROADMAP C.4), so this one holds invariants of the port's
counts instead: on a fake 8-rank (2, 2, 2) ("pod", "data", "model") world,
reduced
jamba-1.5-large-398b and granite-moe-3b-a800m under ``remat="full"``,
``fsdp=True`` and 2 microbatches count flops and memory on rank 0,
collectives under fsdp and a useful flops ratio in (0, 1]; a reduced
FALKON solver cell reads exactly one all-reduce of M * p floats a sweep;
``main`` writes a gemma3-1b decode cell's artifact. No process is spawned.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import ShapeCell, reduced_config
from repro_torch.distributed.mesh import AxisRules, use_rules
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline import derive_roofline, memory_report, analyze

CELLS = (ShapeCell("mini_train", 64, 8, "train"), ShapeCell("mini_decode", 64, 8, "decode"))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test, beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_mini_dryrun_train_and_decode():
    """Both architectures' train and decode cells in one fake world, as the
    reference test runs them on one mesh (DTensor's sharding propagation,
    the time of a first call on a 3-D mesh, is cached across them)."""
    with dryrun.fake_world(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        rules = AxisRules(mesh=mesh, fsdp=True)
        for arch in ("jamba-1.5-large-398b", "granite-moe-3b-a800m"):
            cfg = dataclasses.replace(reduced_config(arch), remat="full", fsdp=True)
            for cell in CELLS:
                mb = 2 if cell.kind == "train" else 0
                *args, model_flops = dryrun.cell_args(cfg, cell, mb, rules)
                with use_rules(rules):
                    cost = analyze(*args)
                roof = derive_roofline(cost, chips=8, model_flops=model_flops)
                mem = memory_report(cost)
                tag = (arch, cell.name)
                assert roof.flops_per_device > 0, tag
                assert mem["total_per_device"] > 0 and mem["argument_size_in_bytes"] > 0, tag
                assert mem["alias_size_in_bytes"] > 0, tag     # written in place
                assert sum(roof.collective_bytes.values()) > 0, (tag, roof.collective_bytes)
                assert 0.0 < roof.useful_flops_ratio <= 1.0, (tag, roof.useful_flops_ratio)
                assert roof.unbounded_whiles == 0
                assert roof.xla_flops_once == roof.flops_per_device


def test_falkon_cell_reads_one_all_reduce_a_sweep():
    """A reduced solver cell on the 256-rank production mesh: t CG sweeps
    and the right-hand side's, each one all-reduce of the (M, 1) partial
    (M floats, 4 bytes each), and nothing else on the wire."""
    n, d, M, t = 65_536, 8, 64, 3
    res = dryrun.run_falkon_cell(False, block_size=4096, n=n, d=d, M=M, t=t)
    assert res["status"] == "ok" and res["chips"] == 256
    assert res["psums"] == t + 1 and res["psum_floats"] == (t + 1) * M
    assert res["roofline"]["collective_bytes"] == {"all-reduce": float((t + 1) * M * 4)}
    # each rank sweeps its n / 16 rows: the cross term, K u and K^T t
    assert res["roofline"]["flops_per_device"] >= (t + 1) * 2 * (n // 16) * M * (d + 2)
    assert 0.0 < res["roofline"]["useful_flops_ratio"] <= 1.0


def test_main_writes_a_decode_cell(tmp_path):
    code = dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh", "single",
                        "--out", str(tmp_path)])
    assert code == 0
    res = json.loads((tmp_path / "gemma3-1b__decode_32k__single.json").read_text())
    assert res["status"] == "ok" and res["chips"] == 256 and res["mesh"] == "16x16"
    assert res["fits_hbm"] and res["roofline"]["bottleneck"] in ("compute", "memory",
                                                                   "collective")
    assert {"memory", "analytic_memory_gb", "bytes_per_device_gb", "roofline",
            "compile_s"} <= set(res)
