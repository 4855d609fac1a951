"""The evaluation's batch read (``utils/artifacts.load_adv_batch``): each
clip read straight into its row of a given buffer (the pinned host buffer
of ``eval/transfer._prefetched_uploads`` on a card) gives the arrays
``np.load`` gives, for float32 and compact float16 artifacts and a
Fortran-ordered file alike; a buffer of another shape, a clip of another
shape and a truncated file are refused."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu_torch.utils import artifacts  # noqa: E402

SHAPE = (3, 4, 8, 8)


def _write(run_dir, label, dtype=np.float32, fortran=False):
    clip = np.random.RandomState(label).randn(*SHAPE).astype(dtype)
    np.save(os.path.join(run_dir, f"{label}-adv.npy"),
            np.asfortranarray(clip) if fortran else clip)
    return clip.astype(np.float32)


@pytest.mark.parametrize("pinned_like", [False, True])
def test_read_into_a_buffer_is_np_load(tmp_path, pinned_like):
    want = [_write(tmp_path, 3), _write(tmp_path, 5, np.float16), _write(tmp_path, 7, fortran=True)]
    files = ["3-adv.npy", "5-adv.npy", "7-adv.npy"]
    assert artifacts.batch_shape(str(tmp_path), files) == (3,) + SHAPE
    out = torch.empty((3,) + SHAPE).numpy() if pinned_like else None
    clips, labels = artifacts.load_adv_batch(str(tmp_path), files, out=out)
    assert clips.dtype == np.float32 and clips.shape == (3,) + SHAPE
    assert labels.tolist() == [3, 5, 7] and labels.dtype == np.int32
    for got, w in zip(clips, want):
        np.testing.assert_array_equal(got, w)
    if out is not None:
        assert clips is out


def test_read_refuses_a_wrong_buffer_or_clip_and_a_truncated_file(tmp_path):
    _write(tmp_path, 1)
    with pytest.raises(ValueError, match="not a C-contiguous float32 batch"):
        artifacts.load_adv_batch(str(tmp_path), ["1-adv.npy"], out=np.empty((1, 3, 4, 8, 7),
                                                                             np.float32))
    np.save(tmp_path / "2-adv.npy", np.zeros((3, 1, 8, 8), np.float16))
    with pytest.raises(ValueError, match="not the batch's"):
        artifacts.load_adv_batch(str(tmp_path), ["1-adv.npy", "2-adv.npy"])
    path = tmp_path / "1-adv.npy"
    path.write_bytes(path.read_bytes()[:-16])
    with pytest.raises(ValueError, match="ends before"):
        artifacts.load_adv_batch(str(tmp_path), ["1-adv.npy"])
