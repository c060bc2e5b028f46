"""The port's URI filesystem layer (wormhole_tpu_torch/data/filesys.py)
and its consumers — match_file, the InputSplit reader, crb, checkpoints —
against the JAX package's, on the CPU.

The five filesystem tests of tests/test_data.py run once for each
package over the same in-memory filesystem and fake S3 client (a scheme
round trip, crb over a registered scheme, S3FS over a fake client, the
guidance of an unbound scheme, a checkpoint through a registered scheme).
Beside them: both packages cut the same chunks and the same batches from
a file on a registered scheme, split into several parts; match_file
lists the same files of a registered scheme; a bad file regex raises the
same ValueError; a file written by one package's crb writer or
checkpoint through the scheme is read back by the other's.
"""

import numpy as np
import pytest

from test_data import _FakeS3Client, _MemFS
from wormhole_tpu.data import crb as jax_crb
from wormhole_tpu.data import filesys as jax_fs
from wormhole_tpu.data import parsers as jax_parsers
from wormhole_tpu.data.match_file import match_file as jax_match
from wormhole_tpu.utils import checkpoint as jax_ckpt
from wormhole_tpu_torch.data import crb as port_crb
from wormhole_tpu_torch.data import filesys as port_fs
from wormhole_tpu_torch.data import parsers as port_parsers
from wormhole_tpu_torch.data.match_file import match_file as port_match
from wormhole_tpu_torch.utils import checkpoint as port_ckpt

PACKAGES = {
    "jax": dict(fs=jax_fs, match=jax_match, parsers=jax_parsers,
                crb=jax_crb, ckpt=jax_ckpt),
    "torch": dict(fs=port_fs, match=port_match, parsers=port_parsers,
                  crb=port_crb, ckpt=port_ckpt),
}
BOTH = pytest.mark.parametrize("name", sorted(PACKAGES))


def _register(scheme, fs):
    """Bind `fs` under `scheme` in both packages' registries."""
    for p in PACKAGES.values():
        p["fs"].register_filesystem(scheme, fs)


def _libsvm_lines(n):
    rng = np.random.default_rng(n)
    return "".join(
        f"{i % 2} " + " ".join(f"{k}:{rng.integers(1, 9)}" for k in
                               sorted(rng.choice(500, 6, replace=False)))
        + "\n" for i in range(n)).encode()


@BOTH
def test_filesys_uri_scheme_roundtrip(name):
    p = PACKAGES[name]
    fsys = p["fs"]
    mem = _MemFS()
    fsys.register_filesystem(f"memrt{name}", mem)
    lines = "".join(f"1 {i}:1\n" for i in range(100)).encode()
    for k in range(2):
        with fsys.open_stream(f"memrt{name}://bucket/data/part-{k}",
                              "wb") as f:
            f.write(lines)
    got = p["match"](f"memrt{name}://bucket/data/part-.*")
    assert got == [f"memrt{name}://bucket/data/part-0",
                   f"memrt{name}://bucket/data/part-1"]
    chunks = p["parsers"].iter_file_chunks
    c0 = "".join(chunks(f"memrt{name}://bucket/data/part-0", 0, 2))
    c1 = "".join(chunks(f"memrt{name}://bucket/data/part-0", 1, 2))
    assert (c0 + c1).encode() == lines
    assert c0 and c1


@BOTH
def test_filesys_crb_over_remote_scheme(name):
    p = PACKAGES[name]
    p["fs"].register_filesystem(f"memcrb{name}", _MemFS())
    blk = p["parsers"].parse_libsvm("1 1:2 3:4\n0 2:1\n")
    p["crb"].write_crb(f"memcrb{name}://b/x.crb", [blk])
    got = list(p["crb"].read_crb(f"memcrb{name}://b/x.crb"))
    assert sum(b.size for b in got) == 2


@BOTH
def test_filesys_s3_adapter_over_fake_client(name):
    p = PACKAGES[name]
    fsys = p["fs"]
    fsys.register_filesystem("s3", fsys.S3FS(client=_FakeS3Client()))
    try:
        for i in range(5):  # >2 objects so list_objects_v2 paginates
            with fsys.open_stream(f"s3://bkt/data/part-{i}", "wb") as f:
                f.write(b"1 1:1\n")
        assert p["match"]("s3://bkt/data/part-.*") == [
            f"s3://bkt/data/part-{i}" for i in range(5)]
        with fsys.open_stream("s3://bkt/data/part-0", "rb") as f:
            assert f.read() == b"1 1:1\n"
        assert fsys.isfile("s3://bkt/data/part-0")
        assert not fsys.isfile("s3://bkt/data/part-9")
        assert fsys.isdir("s3://bkt/data")
        assert fsys.getsize("s3://bkt/data/part-0") == 6
        with pytest.raises(NotImplementedError, match="whole-object"):
            fsys.open_stream("s3://bkt/data/part-0", "ab")
    finally:
        fsys._REGISTRY.pop("s3", None)


@BOTH
@pytest.mark.parametrize("scheme", ["hdfs", "azure"])
def test_filesys_unbound_scheme_guides(name, scheme):
    fsys = PACKAGES[name]["fs"]
    with pytest.raises(NotImplementedError, match="register_filesystem"):
        fsys.open_stream(f"{scheme}://nn/host/file", "rb")
    with pytest.raises(ValueError, match="unknown filesystem scheme"):
        fsys.get_filesystem("weird-scheme://x")


@BOTH
def test_checkpoint_over_remote_scheme(name):
    ckpt = PACKAGES[name]["ckpt"]
    PACKAGES[name]["fs"].register_filesystem(f"memck{name}", _MemFS())
    ckpt.atomic_savez(f"memck{name}://b/model_part-0", w=np.arange(4.0))
    ckpt.atomic_savez(f"memck{name}://b/model_part-1",
                      w=np.arange(4.0, 8.0))
    got = ckpt.load_parts(f"memck{name}://b/model")
    np.testing.assert_array_equal(got["w"], np.arange(8.0))


def test_no_cloud_package_at_import():
    """The port's filesys imports no cloud client, torch or numpy."""
    import subprocess
    import sys

    probe = ("import sys; sys.path.insert(0, sys.argv[1])\n"
             "before = set(sys.modules)\n"
             "import wormhole_tpu_torch.data.filesys\n"
             "import wormhole_tpu_torch.data.match_file\n"
             "bad = sorted(m for m in set(sys.modules) - before if "
             "m.split('.')[0] in "
             "('boto3', 'google', 'torch', 'numpy', 'jax'))\n"
             "assert not bad, bad\n")
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe, root],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr


def test_same_messages_and_exception_types():
    """The refusals carry the JAX package's messages."""
    for scheme in ("hdfs", "azure"):
        msgs = []
        for p in PACKAGES.values():
            with pytest.raises(NotImplementedError) as e:
                p["fs"].list_dir(f"{scheme}://x/y")
            msgs.append(str(e.value).split(".")[0])
        assert msgs[0] == msgs[1]
    msgs = []
    for p in PACKAGES.values():
        s3 = p["fs"].S3FS(client=_FakeS3Client())
        with pytest.raises(NotImplementedError) as e:
            s3.open("b/x", "ab+")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for p in PACKAGES.values():
        assert p["fs"].split_scheme("GS://b/k") == ("gs", "b/k")
        assert p["fs"].split_scheme("/a/b") == ("", "/a/b")
        assert p["fs"].join("memwm://b/", "x") == "memwm://b/x"
        assert p["fs"].dirname("memwm://b/d/x") == "memwm://b/d"
        assert p["fs"].basename("memwm://b/d/x") == "x"


# --------------------------------------------------- the packages together
@pytest.fixture(scope="module")
def shared():
    """One in-memory filesystem bound under one scheme in both packages,
    holding three libsvm files."""
    mem = _MemFS()
    _register("memboth", mem)
    for k, n in enumerate((300, 257, 1)):
        mem.files[f"d/train-{k}.libsvm"] = _libsvm_lines(n)
    mem.files["d/notes.txt"] = b"x\n"
    return mem


@pytest.mark.parametrize("num_parts", [1, 3, 7])
def test_same_chunks_and_batches_over_a_registered_scheme(shared,
                                                          num_parts):
    """iter_file_chunks and MinibatchIter of both packages read the same
    rows of a file on a registered scheme, part by part, and the parts
    cover the file once."""
    from wormhole_tpu.data.minibatch import MinibatchIter as JIter
    from wormhole_tpu_torch.data.minibatch import MinibatchIter as TIter

    uri = "memboth://d/train-0.libsvm"
    whole = b""
    for part in range(num_parts):
        tj = "".join(jax_parsers.iter_file_chunks(uri, part, num_parts,
                                                  chunk_bytes=512))
        tt = "".join(port_parsers.iter_file_chunks(uri, part, num_parts,
                                                   chunk_bytes=512))
        assert tt == tj
        whole += tt.encode()
        bj = list(JIter(uri, part, num_parts, minibatch_size=64))
        bt = list(TIter(uri, part, num_parts, minibatch_size=64,
                        device="cpu"))
        assert [b.size for b in bt] == [b.size for b in bj]
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(np.asarray(a.label),
                                          np.asarray(b.label))
            np.testing.assert_array_equal(np.asarray(a.offset),
                                          np.asarray(b.offset))
            np.testing.assert_array_equal(
                np.asarray(a.index).astype(np.uint64),
                np.asarray(b.index).astype(np.uint64))
    assert whole == shared.files["d/train-0.libsvm"]


def test_port_chunks_of_a_local_path_unchanged(tmp_path):
    """A local path and its file:// URI give the same chunks, cut where
    the port's block reader cut them before it went through filesys."""
    data = _libsvm_lines(400)
    path = tmp_path / "x.libsvm"
    path.write_bytes(data)
    for num_parts in (1, 3):
        for part in range(num_parts):
            plain = list(port_parsers.iter_file_chunks(str(path), part,
                                                       num_parts, 700))
            uri = list(port_parsers.iter_file_chunks(f"file://{path}", part,
                                                     num_parts, 700))
            assert plain == uri
            assert all(c.endswith("\n") for c in plain)
            assert all(len(c.encode()) >= 700 for c in plain[:-1])


def test_match_file_over_a_registered_scheme(shared):
    want = [f"memboth://d/train-{k}.libsvm" for k in range(3)]
    assert port_match("memboth://d/train-.*") == want
    assert jax_match("memboth://d/train-.*") == want
    assert port_match("memboth://d/train-1.libsvm") == [want[1]]
    assert port_match("memboth://nowhere/x.*") == []
    from wormhole_tpu_torch.solver.workload import list_parts, match_file

    assert match_file is port_match
    assert list_parts("memboth://d/train-[01].*", 2) == [
        (want[0], 0, 2), (want[0], 1, 2), (want[1], 0, 2), (want[1], 1, 2)]


@pytest.mark.parametrize("pattern", ["train-(", "[a-"])
def test_bad_file_regex_raises_the_same_value_error(tmp_path, pattern):
    """A pattern whose basename is no regex raises ValueError("bad file
    regex ...") in both packages, with the same message."""
    msgs = []
    for match in (jax_match, port_match):
        with pytest.raises(ValueError, match="bad file regex") as e:
            match(str(tmp_path / pattern))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_crb_and_checkpoints_cross_packages_over_a_scheme():
    """A crb file and a model written by one package through a
    registered scheme are read by the other, the same bytes both ways."""
    mem = _MemFS()
    _register("memx", mem)
    text = _libsvm_lines(50).decode()
    jax_crb.write_crb("memx://b/j.crb", [jax_parsers.parse_libsvm(text)])
    port_crb.write_crb("memx://b/t.crb", [port_parsers.parse_libsvm(text)])
    assert mem.files["b/j.crb"] == mem.files["b/t.crb"]
    (bt,), (bj,) = (list(port_crb.read_crb("memx://b/j.crb")),
                    list(jax_crb.read_crb("memx://b/t.crb")))
    np.testing.assert_array_equal(np.asarray(bt.label), np.asarray(bj.label))
    np.testing.assert_array_equal(np.asarray(bt.index).astype(np.uint64),
                                  np.asarray(bj.index).astype(np.uint64))
    arrays = {"w": np.arange(10, dtype=np.float32),
              "V": np.ones((4, 2), np.float32)}
    port_ckpt.atomic_savez("memx://b/m", compressed=True, **arrays)
    jax_ckpt.atomic_savez("memx://b/j", compressed=True, **arrays)
    for got in (jax_ckpt.load_parts("memx://b/m"),
                port_ckpt.load_parts("memx://b/j"),
                port_ckpt.load_parts("memx://b/m")):
        assert set(got) == set(arrays)
        for k in arrays:
            np.testing.assert_array_equal(got[k], arrays[k])


def test_port_save_model_through_a_registered_scheme(tmp_path):
    """The port's save_model and load_model round-trip a store through a
    registered scheme (no local directory is made for it), and through
    file://."""
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner

    mem = _MemFS()
    port_fs.register_filesystem("memsave", mem)
    cfg = LinearConfig(num_buckets=1 << 10, minibatch=64)
    a = LinearLearner(cfg, device="cpu")
    rng = np.random.default_rng(0)
    a.store.from_numpy({k: rng.normal(size=v.shape).astype(np.float32)
                        for k, v in a.store.to_numpy().items()})
    for base in ("memsave://bucket/models/lin", f"file://{tmp_path}/lin"):
        paths = port_ckpt.save_model(a.store, base, 3)
        assert paths == [base + "_iter-3.npz"]
        b = LinearLearner(cfg, device="cpu")
        port_ckpt.load_model(b.store, base, 3)
        want, got = a.store.to_numpy(), b.store.to_numpy()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert set(mem.files) == {"bucket/models/lin_iter-3.npz"}
    assert (tmp_path / "lin_iter-3.npz").exists()
