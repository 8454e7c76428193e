"""``zultra_tpu_torch/smoke_golden.json`` is the byte oracle of
chip_smoke.py on the card, where zultra_tpu is not imported: for each
smoke case, the input's recipe and digest and the length and digest of
what ``zultra_tpu.compress`` writes on the native engine. This test
recomputes every entry, so the file cannot go stale. Tolerance: exact.

    python tests/test_torch_golden.py --write   # rewrite the file
"""

import hashlib
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import zultra_tpu as zt  # noqa: E402
from zultra_tpu import engine  # noqa: E402
from zultra_tpu_torch.corpus import case_inputs  # noqa: E402

GOLDEN = REPO / "zultra_tpu_torch" / "smoke_golden.json"
MIB = 1 << 20
MIXED = ["mixed_corpus", 4 * MIB, 0]

# name, recipe, input slice, flags, block size, dictionary slice
CASES = [
    ("gzip", MIXED, [0, 4 * MIB], 2, 0, None),
    ("deflate", MIXED, [0, MIB], 0, 0, None),
    ("zlib", MIXED, [MIB, 2 * MIB], 1, 65536, None),
    ("dictionary", MIXED, [2 * MIB, 2 * MIB + 300000], 1, 0, [0, 3000]),
    ("stored", ["random_bytes", 65536, 0], [0, 65536], 2, 0, None),
    # 33 windows of 64 KiB (the last 12345 bytes): three device batches
    ("stream", MIXED, [0, 2109497], 2, 65536, None),
    # zultra's largest block size on text: two windows, each one block of
    # 2^21 positions, DP lanes past 2^20
    ("text2m", ["text_corpus", 4 * MIB, 0], [0, 4 * MIB], 2, 2 * MIB, None),
]


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def compute_golden() -> dict:
    engine.set_engine("native")
    try:
        cases = []
        for name, recipe, span, flags, block, dic in CASES:
            case = {"name": name, "recipe": recipe, "input": span, "dictionary": dic,
                    "flags": flags, "block_size": block}
            data, dictionary = case_inputs(case)
            out = zt.compress(data, flags, block, dictionary)
            case.update(input_sha256=_sha(data), out_len=len(out), out_sha256=_sha(out))
            cases.append(case)
    finally:
        engine._active_engine = None
    return {"oracle": "zultra_tpu.compress on the native engine "
                      "(python tests/test_torch_golden.py --write)",
            "cases": cases}


@pytest.fixture(scope="module")
def recomputed():
    return compute_golden()


@pytest.mark.parametrize("i", range(len(CASES)))
def test_golden_entry_is_current(recomputed, i):
    golden = json.loads(GOLDEN.read_text())
    assert len(golden["cases"]) == len(CASES)
    assert golden["cases"][i] == recomputed["cases"][i]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    GOLDEN.write_text(json.dumps(compute_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
