"""The port's dry-run tooling (``repro_torch.launch.dryrun``,
``launch.comm_analysis``, ``common.constants``, the shape grid of
``configs.base``) against the reference's, on the CPU.

* ``wire_bytes`` is the reference's ring model
  (``repro.launch.hlo_analysis._wire_bytes``, a module without JAX) for
  every kind and group size 1..8, and ``collective_stats`` sums a
  ``core.collectives.timed()`` record by it;
* ``model_flops_lm`` and ``model_flops_fno`` are the reference's formulas
  (``repro/launch/dryrun.py:214-245``, written out here from the
  reference's configs: importing that module sets ``XLA_FLAGS`` to 512
  host devices) for every cell of the grid;
* the shape grid and ``cell_supported`` are the reference's;
* the dry-run's per-rank parameter bytes of every reduced config on
  (1 x 2), (2 x 2) and (1 x 4) are those of ``shard_params`` on 4 gloo
  ranks (``tests/torch_dryrun_checks.py``);
* whisper's per-rank cache bytes are those ``init_whisper_cache`` holds on
  a rank (padded heads), every artifact names what it does not count
  (activations), ``--list`` and ``--all`` run;
* the port's CLIs take ``--devices N`` and ``--devices=N`` alike (the
  fault the reference's ``sniff_devices`` fixed, ``tests/test_streaming.py``);
  the port has no counterpart of ``launch/devices.py`` or
  ``common/compat.py``: nothing in it sets a host device count or XLA
  flags.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

import torch_dryrun_checks as rank_side
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import FNO_IDS as JFNO_IDS
from repro.configs import LM_SHAPES as JLM_SHAPES
from repro.configs import cell_supported as jcell_supported
from repro.configs import get_arch as jget_arch
from repro.configs import get_fno as jget_fno
from repro.launch.hlo_analysis import _wire_bytes
from repro_torch.configs import ARCH_IDS, FNO_IDS, get_arch, get_fno, reduced
from repro_torch.configs.base import LM_SHAPES, cell_supported, get_shape, input_specs
from repro_torch.launch import comm_analysis, dryrun
from repro_torch.launch.mesh import launch_ranks
from repro_torch.models import whisper as twhisper
from torch_dist_checks import one_launch_at_a_time

REPO = os.path.join(os.path.dirname(__file__), "..")
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute", "x")


@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_is_the_references_ring_model(kind):
    for g in range(1, 9):
        for nbytes in (0, 1, 96, 4096, 3 << 20):
            assert comm_analysis.wire_bytes(kind, nbytes, g) == _wire_bytes(kind, nbytes, g)


def test_collective_stats_sum_a_timed_record():
    ops = [("all-reduce", 1024, 4), ("all-gather", 8192, 4), ("all-reduce", 1024, 4),
           ("all-to-all", 800, 2), ("all-reduce", 64, 1)]
    st = comm_analysis.collective_stats(ops)
    assert st.count_by_kind == {"all-reduce": 3, "all-gather": 1, "all-to-all": 1}
    assert st.bytes_by_kind["all-reduce"] == 2 * 2 * 1024 * 3 / 4
    assert st.total_bytes == sum(_wire_bytes(*op) for op in ops)
    assert st.top_sites(1)[0] == ("all-gather of 8192 B over 4", 6144.0)
    assert "all-gather 0.01 MiB (1 calls)" in comm_analysis.wire_line(ops)


def test_the_shape_grid_is_the_references():
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in LM_SHAPES] == [
        (s.name, s.seq_len, s.global_batch, s.kind) for s in JLM_SHAPES]
    assert ARCH_IDS == JARCH_IDS and FNO_IDS == JFNO_IDS
    for arch in ARCH_IDS:
        for shape, jshape in zip(LM_SHAPES, JLM_SHAPES):
            assert cell_supported(get_arch(arch), shape) == jcell_supported(jget_arch(arch), jshape)
    w = get_arch("whisper-tiny")
    assert input_specs(w, get_shape("train_4k"))["frames"] == ((256, 1500, 384), torch.bfloat16)
    assert input_specs(w, get_shape("decode_32k")) == {"token": ((128, 1), torch.int32),
                                                       "index": ((), torch.int32)}


def _ref_flops_lm(jcfg, shape) -> float:
    n = jcfg.approx_active_params()
    mult = {"train": 6.0 * shape.seq_len, "prefill": 2.0 * shape.seq_len, "decode": 2.0}
    return mult[shape.kind] * n * shape.global_batch


def _ref_flops_fno(jcfg, batch, kind) -> float:
    nx, ny, nz, nt = jcfg.grid
    pts, w = nx * ny * nz * nt, jcfg.width
    per_block = (8.0 * w * w * math.prod(jcfg.mode_shape) + 2.0 * w * w * pts
                 + 2 * 5.0 * pts * w * sum(math.log2(n) for n in jcfg.grid))
    enc = 2.0 * jcfg.in_channels * w * pts
    dec = 2.0 * w * jcfg.decoder_dim * pts + 2.0 * jcfg.decoder_dim * jcfg.out_channels * pts
    fwd = batch * (enc + dec + jcfg.n_blocks * per_block)
    return 3.0 * fwd if kind == "train" else fwd


def test_model_flops_are_the_references_for_every_cell():
    cells = list(dryrun.iter_cells())
    lm = sum(cell_supported(get_arch(a), s)[0] for a in ARCH_IDS for s in LM_SHAPES)
    assert len(cells) == lm + sum(len(get_fno(f)[1]) for f in FNO_IDS)
    for kind, arch, shape in cells:
        if kind == "lm":
            got = dryrun.model_flops_lm(get_arch(arch), get_shape(shape))
            want = _ref_flops_lm(jget_arch(arch), next(s for s in JLM_SHAPES if s.name == shape))
        else:
            batch, k = {n: (b, k) for n, b, k in get_fno(arch)[1]}[shape]
            got = dryrun.model_flops_fno(get_fno(arch)[0], batch, k)
            want = _ref_flops_fno(jget_fno(arch)[0], batch, k)
        assert got == pytest.approx(want, rel=1e-12), (arch, shape)


@pytest.fixture(scope="module")
def rank_bytes(tmp_path_factory):
    with one_launch_at_a_time():
        return launch_ranks(rank_side.param_bytes, 4, str(tmp_path_factory.mktemp("dryrun")),
                            args=(None,), deadline_s=240, device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_param_bytes_equal_the_ranks_shards(rank_bytes, arch):
    """Every rank's ``shard_params`` of a reduced config holds exactly the
    bytes the dry-run counts for one rank of that mesh."""
    cfg = reduced(get_arch(arch))
    for mesh, (d, p) in {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}.items():
        want = dryrun.lm_param_bytes(cfg, d, p)
        held = [r[arch, mesh] for r in rank_bytes if (arch, mesh) in r]
        assert held and held == [want] * len(held), (arch, mesh, held, want)
    assert dryrun.lm_param_bytes(cfg, 1, 1) == sum(
        t.numel() * t.element_size() for _, t in rank_side._leaves(rank_side.whole_params(cfg)))


def test_whisper_cache_bytes_count_the_padded_heads():
    """whisper-tiny's 6 heads pad to 8 on 4 model ranks: 2 a rank, bf16,
    rows over the data axis (whole where it does not divide them)."""
    cfg = get_arch("whisper-tiny")
    per_head_row = 2 * cfg.n_layers * cfg.head_dim_ * (448 + cfg.encoder.frames) * 2
    assert dryrun.lm_cache_bytes(cfg, 1, 4, 4, 448) == 4 * 2 * per_head_row
    assert dryrun.lm_cache_bytes(cfg, 2, 2, 4, 448) == 2 * 3 * per_head_row
    assert dryrun.lm_cache_bytes(cfg, 4, 1, 2, 448) == 2 * 6 * per_head_row
    pol = dryrun.mesh_policy(1, 4)
    assert twhisper.cache_heads(cfg, pol) == 2


def test_dryrun_cli_writes_one_artifact_a_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    out = subprocess.run(run + ["--list"], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0 and len(out.stdout.splitlines()) == len(list(dryrun.iter_cells()))
    out = subprocess.run(run + ["--all", "--mesh", "8x4", "--out-dir", str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    files = sorted(os.listdir(tmp_path))
    assert len(files) == len(list(dryrun.iter_cells()))
    art = json.load(open(tmp_path / "whisper-tiny_train_4k_8x4.json"))
    mem = art["memory"]
    assert {"params", "grads", "adamw", "inputs", "resident_bytes", "fits"} <= set(mem)
    assert "activations" in mem["not_counted"]
    assert mem["resident_bytes"] == sum(mem[k] for k in ("params", "grads", "adamw", "inputs"))
    assert art["model_flops"] > 0 and art["floor_s"]["compute"] > 0 and art["floor_s"]["hbm"] > 0
    assert f"{len(files)} cells" in out.stdout


@pytest.mark.parametrize("cli", ["train", "serve_pde"])
def test_cli_takes_both_forms_of_devices(cli):
    import importlib

    parser = importlib.import_module(f"repro_torch.launch.{cli}").build_parser()
    spaced = parser.parse_args(["--ckpt-dir", "ck", "--devices", "4"])
    joined = parser.parse_args(["--ckpt-dir", "ck", "--devices=4"])
    assert spaced.devices == joined.devices == 4
