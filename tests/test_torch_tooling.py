"""The port's chip tooling on the CPU: ``chip_smoke.py`` and every family
of ``python3 -m zultra_tpu_torch.kernel_bench`` import all they use and
stop at once without a card (exit 2, "no CUDA device" on stderr, no
traceback), and ``kernel_bench.device_ms`` files a trace's op under the
port's kernel it names and under nothing else."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from zultra_tpu_torch import kernel_bench

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("argv", [["chip_smoke.py"]] + [
    ["-m", "zultra_tpu_torch.kernel_bench", family] for family in kernel_bench.FAMILIES],
    ids=lambda argv: argv[-1])
def test_tool_stops_without_a_card(argv):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run([sys.executable, *argv], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 2, done.stderr
    assert "no CUDA device" in done.stderr
    assert "Traceback" not in done.stderr
    assert done.stdout == ""


@pytest.mark.parametrize("key, family, name", [
    ("dp_spec_kernel", "dp", "dp_spec_kernel"),
    ("walk_sweep_kernel", "walk", "walk_sweep_kernel"),
    ("walk_chunk_kernel", "walk", "walk_chunk_kernel"),
    ("suffix_round_kernel", "suffix_round", "suffix_round_kernel"),
    ("prep_lanes_kernel", "prep_lanes", "prep_lanes_kernel"),
    ("void walk_sweep_kernel<32>(int const*, int*, int)", "walk", "walk_sweep_kernel"),
    ("(anonymous namespace)::token_hist_kernel<true, false>(HistArgs)", "token_hist",
     "token_hist_kernel"),
    ("(anonymous namespace)::rank_scatter_kernel(int const*, int*)", "suffix_round",
     "rank_scatter_kernel"),
])
def test_device_ms_names_the_ports_kernels(key, family, name):
    assert kernel_bench.kernel_name(key, kernel_bench.PATTERNS[family]) == name


@pytest.mark.parametrize("key", [
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>, "
    "std::array<char*, 1ul> >(int, at::native::FillFunctor<int>, std::array<char*, 1ul>)",
    "(anonymous namespace)::token_hist_kernel<true, false>(HistArgs)",  # not the byte histogram
    "cudaLaunchKernel",
])
@pytest.mark.parametrize("family", ["hist", "walk", "dp", "rle_stats", "lex_order"])
def test_device_ms_matches_no_other_op(key, family):
    assert kernel_bench.kernel_name(key, kernel_bench.PATTERNS[family]) is None


@pytest.mark.parametrize("key, zeroing", [
    ("Memset (Device)", True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<int>, std::array<char*, 1ul>)", True),
    ("(anonymous namespace)::emit_tokens_kernel<true>(EmitArgs)", False),
])
def test_zeroing_pattern_names_memsets_and_fills(key, zeroing):
    assert kernel_bench.kernel_name(key, kernel_bench.ZEROING) == (key if zeroing else None)
