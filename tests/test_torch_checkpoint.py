"""The port's checkpoints against ``repro.checkpoint``.

A tree written by either package loads in the other with identical arrays,
and the two write identical ``manifest.json`` text for the same tree (numpy
leaves in ``repro``, numpy or torch leaves in the port). A corrupted newest
step falls back to the previous one, all-corrupt raises, and an explicit
corrupt step fails hard, as in ``repro``. bfloat16 leaves round-trip as
their bit pattern without ``ml_dtypes``, and load in ``repro`` as its
bfloat16. ``CheckpointManager`` keeps the newest ``keep`` steps and saves
in the background.
"""

import json
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import ckpt as R_ckpt  # noqa: E402

from repro_torch.checkpoint import ckpt as T_ckpt  # noqa: E402


class Pair(NamedTuple):
    lo: object
    hi: object


def numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                   "b": np.arange(3, dtype=np.int32)},
        "opt": [np.float64(0.5) * np.ones(2), (np.array([True, False]),
                                              np.int64(7))],
        "pair": Pair(np.uint8([1, 2, 3]), np.zeros((0, 2), np.float32)),
        "10": np.array(1.5, np.float32),          # sorts before "2"
        "2": np.array([3], np.int16),
    }


def to_torch(tree):
    return T_ckpt._map_leaves(lambda v: torch.from_numpy(np.asarray(v)),
                              tree)


def flat_np(tree):
    return {k: np.asarray(v) for k, v in T_ckpt._flatten(tree).items()}


def assert_same_leaves(got, want):
    got, want = flat_np(got), flat_np(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def manifest(path, step):
    return (path / f"step_{step:010d}" / "manifest.json").read_text()


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_port_writes_what_repro_reads(tmp_path, leaves):
    tree = numpy_tree()
    src = tree if leaves == "numpy" else to_torch(tree)
    T_ckpt.save_checkpoint(tmp_path / "t", 5, src, extra={"k": [1, "x"]})
    R_ckpt.save_checkpoint(tmp_path / "r", 5, tree, extra={"k": [1, "x"]})
    assert manifest(tmp_path / "t", 5) == manifest(tmp_path / "r", 5)
    got, extra, step = R_ckpt.load_checkpoint(tmp_path / "t", tree)
    assert (step, extra) == (5, {"k": [1, "x"]})
    assert_same_leaves(got, tree)
    assert isinstance(got["pair"], Pair)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_repro_writes_what_port_reads(tmp_path, device):
    tree = numpy_tree(1)
    R_ckpt.save_checkpoint(tmp_path, 9, tree, extra={"a": 1})
    got, extra, step = T_ckpt.load_checkpoint(tmp_path, tree, device=device)
    assert (step, extra) == (9, {"a": 1})
    kind = np.ndarray if device is None else torch.Tensor
    assert all(isinstance(v, kind) for v in T_ckpt._flatten(got).values())
    if device is not None:
        got = T_ckpt._map_leaves(lambda t: t.numpy(), got)
    assert_same_leaves(got, tree)
    assert T_ckpt.latest_step(tmp_path) == 9
    (tmp_path / "step_0000000011.tmp").mkdir()      # never committed
    assert T_ckpt.latest_step(tmp_path) == 9


def _flip_a_bit(path, step):
    npz = path / f"step_{step:010d}" / "shard_0.npz"
    with np.load(npz) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    arrays[sorted(arrays)[0]].view(np.uint8)[3] ^= 0x10
    np.savez(npz, **arrays)


def test_corrupt_newest_step_falls_back(tmp_path):
    tree = {"w": np.arange(64, dtype=np.float32)}
    T_ckpt.save_checkpoint(tmp_path, 10, tree, extra={"step": 10})
    T_ckpt.save_checkpoint(tmp_path, 20, to_torch(tree), extra={"step": 20})
    _flip_a_bit(tmp_path, 20)
    got, extra, step = T_ckpt.load_checkpoint(tmp_path, tree)
    assert step == 10 and extra == {"step": 10}
    np.testing.assert_array_equal(got["w"], tree["w"])
    with pytest.raises(ValueError, match="crc32 mismatch"):
        T_ckpt.load_checkpoint(tmp_path, tree, step=20)
    # repro agrees on the same directory
    assert R_ckpt.load_checkpoint(tmp_path, tree)[2] == 10


def test_all_steps_corrupt_raises(tmp_path):
    tree = {"w": np.ones(8, np.float32)}
    T_ckpt.save_checkpoint(tmp_path, 1, tree)
    T_ckpt.save_checkpoint(tmp_path, 2, tree)
    _flip_a_bit(tmp_path, 1)
    _flip_a_bit(tmp_path, 2)
    with pytest.raises(ValueError, match="failed integrity"):
        T_ckpt.load_checkpoint(tmp_path, tree)
    with pytest.raises(FileNotFoundError):
        T_ckpt.load_checkpoint(tmp_path / "empty", tree)


def test_bfloat16_round_trips_and_loads_in_repro(tmp_path):
    import ml_dtypes
    w = torch.tensor([[1.5, -0.0, float("inf")], [float("nan"), 3e38, 1e-40]],
                     dtype=torch.bfloat16)
    tree = {"w": w, "step": torch.tensor(3)}
    T_ckpt.save_checkpoint(tmp_path / "t", 1, tree)
    got, _, _ = T_ckpt.load_checkpoint(tmp_path / "t", tree)
    assert got["w"].dtype == torch.bfloat16 and got["w"].device.type == "cpu"
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    assert isinstance(got["step"], np.ndarray) and got["step"] == 3
    on = T_ckpt.load_checkpoint(tmp_path / "t", tree, device="cpu")[0]
    assert on["w"].dtype == torch.bfloat16
    # repro reads the bit view as its ml_dtypes bfloat16, and writes the
    # same manifest for that array
    r_got, _, _ = R_ckpt.load_checkpoint(tmp_path / "t", tree)
    assert r_got["w"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(r_got["w"].view(np.uint16),
                                  w.view(torch.int16).numpy().view(np.uint16))
    R_ckpt.save_checkpoint(tmp_path / "r", 1, r_got)
    assert manifest(tmp_path / "t", 1) == manifest(tmp_path / "r", 1)
    back, _, _ = T_ckpt.load_checkpoint(tmp_path / "r", tree)
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
    assert json.loads(manifest(tmp_path / "t", 1))["dtypes"]["w"] \
        == "bfloat16"


def test_manager_keeps_two_and_saves_in_background(tmp_path):
    mgr = T_ckpt.CheckpointManager(str(tmp_path), keep=2)
    w = torch.arange(6, dtype=torch.float32)
    for step in (1, 2, 3):
        mgr.save(step, {"w": w}, extra={"s": step}, blocking=False)
        w += 1                  # after the snapshot: not in the file
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000002", "step_0000000003"]
    got, extra, step = mgr.restore({"w": w})
    assert step == 3 and extra == {"s": 3}
    np.testing.assert_array_equal(got["w"], np.arange(6) + 2.0)
    got, _, _ = mgr.restore({"w": w}, step=2, device="cpu")
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32) + 1)
