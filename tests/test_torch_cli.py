"""The port's front ends over its ``Stream`` on the CPU: the cooperative
``ZultraStream``, the CLI's guarded output arena, and the command-line
tool (``main(argv, device="cpu")``), against ``zultra_tpu.compress`` on
the native engine (tolerance: exact bytes); the CLI's exit codes and
messages; and a subprocess run of ``python -m zultra_tpu_torch.cli`` that
loads no jax and no zultra_tpu module."""

import subprocess
import sys
import zlib
from pathlib import Path

import pytest
import torch

import zultra_tpu as zt
from zultra_tpu import engine
from zultra_tpu_torch import FINALIZE, Stream, StreamError
from zultra_tpu_torch.cli import compress_guarded, main
from zultra_tpu_torch.compat import OK, STREAM_END, ZultraStream, memory_compress
from zultra_tpu_torch.corpus import mixed_corpus

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def native():
    engine.set_engine("native")
    yield
    engine._active_engine = None


def test_guarded_arena(native):
    """The CLI's benchmark path: the stream writes every window into a
    memoryview between two guard regions, which stay intact; an arena
    below the memory bound is refused."""
    data = mixed_corpus(20000, seed=78)
    assert compress_guarded(data, 2, device="cpu") == zt.compress(data, 2)
    with pytest.raises(StreamError, match="arena"):
        Stream(0, 32768, out_buffer=bytearray(1000), device="cpu")


def test_zultra_stream_drip(native):
    """The cooperative wrapper fed in 5000-byte chunks and drained 1000
    bytes at a time equals the one-shot bytes."""
    data = mixed_corpus(12000, seed=79)
    want = zt.compress(data, 1)
    strm = ZultraStream(1, device="cpu")
    out = bytearray()
    for i in range(0, len(data), 5000):
        strm.next_in = data[i : i + 5000]
        status, piece = strm.compress(0, max_out=1000)
        assert status == OK
        out += piece
    while True:
        status, piece = strm.compress(FINALIZE, max_out=1000)
        assert len(piece) <= 1000
        out += piece
        if status == STREAM_END:
            break
    assert bytes(out) == want
    assert memory_compress(data, 1, device="cpu") == want
    assert (strm.total_in, strm.total_out) == (len(data), len(want))
    assert strm.adler == zlib.adler32(data)


def test_cli_gzip_verify(native, tmp_path, capsys):
    data = mixed_corpus(9000, seed=81)
    src, out = tmp_path / "in.bin", tmp_path / "out.gz"
    src.write_bytes(data)
    assert main(["-gzip", "-v", "-c", str(src), str(out)], device="cpu") == 0
    assert "verified OK" in capsys.readouterr().out
    assert out.read_bytes() == zt.compress(data, 2)
    assert zlib.decompress(out.read_bytes(), 31) == data


def test_cli_zlib_dictionary(native, tmp_path):
    """-D keeps the dictionary file's last 32 KB, as the reference CLI."""
    dictionary = mixed_corpus(40000, seed=82)
    data = dictionary[-5000:] + mixed_corpus(4000, seed=83)
    src, dic, out = tmp_path / "in.bin", tmp_path / "dict.bin", tmp_path / "out.zz"
    src.write_bytes(data)
    dic.write_bytes(dictionary)
    assert main(["-zlib", "-D", str(dic), "-c", str(src), str(out)], device="cpu") == 0
    assert out.read_bytes() == zt.compress(data, 1, 0, dictionary[-32768:])


def test_cli_cbench(tmp_path, capsys):
    """-cbench: five guarded runs through the port's Stream, then a zlib
    round trip."""
    src = tmp_path / "in.bin"
    src.write_bytes(mixed_corpus(3000, seed=84))
    assert main(["-deflate", "-cbench", str(src)], device="cpu") == 0
    assert "best" in capsys.readouterr().out


@pytest.mark.parametrize("argv,message", [
    (["-x", "a", "b"], "unknown option -x"),
    (["-gzip", "-D", "dict", "a", "b"], "only supported with zlib"),
    ([], "usage: python -m zultra_tpu_torch.cli"),
    (["-cbench"], "usage: zultra_tpu_torch -cbench"),
])
def test_cli_errors_exit_100(argv, message, capsys):
    assert main(argv, device="cpu") == 100
    assert message in capsys.readouterr().err


def test_cli_empty_input(tmp_path, capsys):
    src = tmp_path / "empty.bin"
    src.write_bytes(b"")
    assert main(["-gzip", str(src), str(tmp_path / "o.gz")], device="cpu") == 100
    assert "error compressing" in capsys.readouterr().err


@pytest.mark.parametrize("fault", ["raises", "corrupt"])
def test_self_test_probes_hide_no_fault(monkeypatch, capsys, fault):
    """The self-test's tiny-input probes let only the empty input's
    StreamError pass: a kernel's error on a 1-11 byte input propagates,
    and a probe whose bytes do not inflate back fails the run (exit 100)."""
    from zultra_tpu_torch import cli

    real = cli.compress

    def faulty(data, flags, **kw):
        if 0 < len(data) < 12:
            if fault == "raises":
                raise RuntimeError("kernel launch failed")
            return zlib.compress(data + b"x")
        return real(data, flags, **kw)

    monkeypatch.setattr(cli, "compress", faulty)
    if fault == "raises":
        with pytest.raises(RuntimeError, match="launch"):
            main(["-quicktest"], device="cpu")
    else:
        assert main(["-quicktest"], device="cpu") == 100
        assert "tiny input of 1 bytes" in capsys.readouterr().err


def test_cli_module_loads_no_jax(tmp_path):
    """``python -m zultra_tpu_torch.cli`` runs as a program (usage error,
    exit 100), and a CLI compression in a fresh interpreter loads no jax
    and no zultra_tpu module."""
    proc = subprocess.run([sys.executable, "-m", "zultra_tpu_torch.cli"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 100 and "usage" in proc.stderr
    src = tmp_path / "in.bin"
    src.write_bytes(mixed_corpus(2000, seed=85))
    code = (
        "import sys\n"
        "from zultra_tpu_torch.cli import main\n"
        f"rc = main(['-deflate', '-c', {str(src)!r}, {str(tmp_path / 'o')!r}], device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'zultra_tpu'))\n"
        "print('RC', rc, 'LOADED', bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert "RC 0 LOADED []" in proc.stdout, proc.stdout + proc.stderr
