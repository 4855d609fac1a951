"""The port's data layer against the JAX package's, on the CPU.

Every comparison is bitwise: the transforms, the manifests, the Kinetics and
UCF-101 items (float32 and uint8), the seeded resample of a bad file, and the
uint8 ingest on the device side. Inputs are numpy draws from a seed; videos
and JPEGs are written by the tests themselves (sidecar ``.npy`` files, MJPEG
AVIs through ``avi_synth`` and the native FFmpeg decoder, Pillow JPEGs).
"""

import filecmp
import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.data import kinetics as jkinetics  # noqa: E402
from i2v_tpu.data import native as jnative  # noqa: E402
from i2v_tpu.data import transforms as jtfm  # noqa: E402
from i2v_tpu.data import ucf101 as jucf101  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu_torch.data import decode, kinetics, native, pipeline  # noqa: E402
from i2v_tpu_torch.data import transforms as tfm  # noqa: E402
from i2v_tpu_torch.data import ucf101  # noqa: E402
from i2v_tpu_torch.data.avi_synth import write_mjpeg_avi  # noqa: E402
from i2v_tpu_torch.ops import pixel  # noqa: E402
from i2v_tpu_torch.utils import paths  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFESTS = ("kinetics400_attack_samples.csv", "test01_setting.txt", "used_idxs.pkl")


def _u8(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


def _pil(frames):
    return [Image.fromarray(f) for f in frames]


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- manifests -----------------------------------------------------------------------------

def test_manifest_copies_are_the_jax_packages_bytes():
    assert paths.MANIFEST_DIR == os.path.join(REPO, "i2v_tpu_torch", "manifests")
    for name in MANIFESTS:
        assert filecmp.cmp(os.path.join(paths.MANIFEST_DIR, name),
                           os.path.join(REPO, "i2v_tpu", "manifests", name), shallow=False)


def test_read_manifest_gives_pandas_rows():
    path = os.path.join(paths.MANIFEST_DIR, MANIFESTS[0])
    got = [(s.path, s.label, s.clip_index) for s in kinetics.read_manifest(path)]
    want = [(s.path, s.label, s.clip_index) for s in jkinetics.read_manifest(path)]
    assert len(got) == 400 and got == want
    assert all(type(v) is int for row in got for v in row[1:])


def test_read_setting_and_used_idxs_match_jax():
    setting = os.path.join(paths.MANIFEST_DIR, MANIFESTS[1])
    used = os.path.join(paths.MANIFEST_DIR, MANIFESTS[2])
    assert ucf101.read_setting(setting, "root") == [
        ucf101.UCFSample(s.directory, s.duration, s.label)
        for s in jucf101.read_setting(setting, "root")]
    assert ucf101.load_used_idxs(used) == jucf101.load_used_idxs(used)
    assert len(ucf101.load_used_idxs(used)) == 101


# -- transforms ----------------------------------------------------------------------------

@pytest.mark.parametrize("hw,size", [((32, 40), 32), ((40, 32), 32), ((30, 50), 20),
                                     ((50, 30), 24), ((31, 47), 37)])
def test_spatial_transforms_match_jax(hw, size):
    img = _u8(1, hw + (3,))
    _same(tfm.resize_short_side(img, size), jtfm.resize_short_side(Image.fromarray(img), size))
    for crop in (size - 7, size, max(hw) + 3):  # the last crop leaves the frame: zeros
        _same(tfm.center_crop(img, crop), jtfm.center_crop(Image.fromarray(img), crop))
        _same(tfm.corner_crop_center(img, crop),
              jtfm.corner_crop_center(Image.fromarray(img), crop))
    for fn in ("multiscale_corner_crop", "multiscale_random_crop"):
        for scales in ((1.0, 0.8), (0.5,)):
            _same(getattr(tfm, fn)(img, 16, scales),
                  getattr(jtfm, fn)(Image.fromarray(img), 16, scales))
    _same(tfm.random_horizontal_flip(img), jtfm.random_horizontal_flip(Image.fromarray(img)))


@pytest.mark.parametrize("thw,short,crop", [
    ((3, 256, 340), 256, 224),   # the decode size: no resize, no Pillow
    ((2, 48, 64), 32, 24),       # a resize (Pillow's bilinear)
    ((2, 64, 48), 40, 40),
])
def test_kinetics_and_ucf_pipelines_match_jax(thw, short, crop):
    frames = _u8(2, thw + (3,))
    _same(tfm.kinetics_val_frames_u8(frames, short, crop),
          jtfm.kinetics_val_frames_u8(frames, short, crop))
    _same(tfm.kinetics_val_transform(frames, short, crop),
          jtfm.kinetics_val_transform(frames, short, crop))
    _same(tfm.ucf_test_frames_u8(list(frames), crop), jtfm.ucf_test_frames_u8(_pil(frames), crop))
    _same(tfm.ucf_test_transform(list(frames), crop), jtfm.ucf_test_transform(_pil(frames), crop))
    _same(tfm.frames_to_normalized_clip(list(frames)), jtfm.frames_to_normalized_clip(_pil(frames)))
    _same(tfm.u8_clip_to_normalized(frames), jtfm.u8_clip_to_normalized(frames))


def test_kinetics_decode_size_needs_no_pillow(monkeypatch):
    frames = _u8(3, (2, 256, 340, 3))
    want = jtfm.kinetics_val_frames_u8(frames)
    monkeypatch.setitem(sys.modules, "PIL", None)
    _same(tfm.kinetics_val_frames_u8(frames), want)
    with pytest.raises(ImportError, match="Pillow is not installed"):
        tfm.kinetics_val_frames_u8(frames[:, :200], 256, 224)


@pytest.mark.parametrize("n", [1, 2, 5, 31, 32, 33, 70])
def test_temporal_crops_match_jax(n):
    idx = list(range(1, n + 1))
    for fn in ("loop_padding", "temporal_begin_crop", "temporal_center_crop",
               "temporal_random_crop"):
        assert getattr(tfm, fn)(list(idx), 32) == getattr(jtfm, fn)(list(idx), 32)


@pytest.mark.parametrize("n_frames,clip_ind,segments", [
    (20, 3, 1), (64, 3, 1),      # short: the window pads with the last frame
    (300, 7, 1), (300, -1, 1),   # long: a seeded window, and the one at the end
    (300, 11, 2), (65, 0, 1),
])
def test_kinetics_clip_indices_match_jax(n_frames, clip_ind, segments):
    _same(tfm.kinetics_clip_indices(n_frames, clip_ind, 32, 2, segments),
          jtfm.kinetics_clip_indices(n_frames, clip_ind, 32, 2, segments))


# -- datasets ------------------------------------------------------------------------------

def _kinetics_files(tmp_path, kind, n=3, frames=12):
    """``n`` videos of ``frames`` frames: .npy sidecars at the decode size, or
    MJPEG AVIs at 64x48 that decode scales; clip indices -1, then seeded."""
    rows = ["path,gt_label,clip_index"]
    for v in range(n):
        clip = _u8(10 + v, (frames, 256, 340, 3) if kind == "npy" else (frames, 48, 64, 3))
        name = f"vid{v}.{kind}"
        if kind == "npy":
            np.save(tmp_path / name, clip)
        else:
            write_mjpeg_avi(str(tmp_path / name), _pil(clip))
        rows.append(f"{name},{v},{v - 1}")
    anno = tmp_path / "anno.csv"
    anno.write_text("\n".join(rows) + "\n")
    return str(anno), str(tmp_path)


def _pair(anno, root, **kw):
    kw = dict(clip_len=4, crop_size=32, **kw)
    return (kinetics.KineticsAttackDataset(anno, root, **kw),
            jkinetics.KineticsAttackDataset(anno, root, **kw))


def _same_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g[0], w[0])
        assert tuple(g[1:]) == tuple(w[1:])


@pytest.mark.parametrize("kind", ["npy", "avi"])
@pytest.mark.parametrize("raw_uint8", [False, True])
def test_kinetics_items_and_batches_match_jax(tmp_path, kind, raw_uint8):
    if kind == "avi":
        assert native.available() and jnative.available()
    ds, jds = _pair(*_kinetics_files(tmp_path, kind), raw_uint8=raw_uint8)
    items = [ds[i] for i in range(len(ds))]
    _same_items(items, [jds[i] for i in range(len(jds))])
    _same_items(ds.load_batch(range(3)), items)
    assert items[0][0].shape == ((4, 32, 32, 3) if raw_uint8 else (3, 4, 32, 32))
    batch = next(kinetics.iterate_batches(ds, 2))
    assert batch["names"] == ["vid0", "vid1"] and batch["clip_inds"] == [-1, 0]
    _same(batch["clips"], np.stack([items[0][0], items[1][0]]))


def test_kinetics_resamples_a_bad_file_as_jax_does(tmp_path):
    anno, root = _kinetics_files(tmp_path, "avi", n=4)
    (tmp_path / "vid1.avi").write_bytes(b"x" * 4096)  # above the size check, undecodable
    ds, jds = _pair(anno, root)
    out = {}
    for name, d in (("port", ds), ("jax", jds)):
        np.random.seed(3)
        with pytest.warns(UserWarning, match="not correctly loaded"):
            out[name] = (d.load_batch(range(4)), d[1])
    _same_items(out["port"][0], out["jax"][0])
    _same_items([out["port"][1]], [out["jax"][1]])
    assert out["port"][0][1][1] != 1


def _ucf_files(tmp_path, n_frames=5, duration=7):
    d = tmp_path / "v_Test_g01_c01"
    d.mkdir()
    for i in range(1, n_frames + 1):
        Image.fromarray(_u8(20 + i, (40, 52, 3))).save(str(d / f"image_{i:05d}.jpg"))
    setting = tmp_path / "setting.txt"
    setting.write_text(f"{d.name} {duration} 17\n")
    return str(setting), str(tmp_path)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("raw_uint8", [False, True])
def test_ucf101_items_match_jax(tmp_path, monkeypatch, use_native, raw_uint8):
    """Seven frames stated, five on disk: both loop over the five."""
    setting, root = _ucf_files(tmp_path)
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    kw = dict(clip_len=8, crop_size=24, raw_uint8=raw_uint8)
    ds = ucf101.UCF101AttackDataset(setting, root, **kw)
    jds = jucf101.UCF101AttackDataset(setting, root, **kw)
    clip, label = ds[0]
    _same(clip, jds[0][0])
    assert label == 17 and clip.shape == ((8, 24, 24, 3) if raw_uint8 else (3, 8, 24, 24))
    batch = next(ucf101.iterate_batches(ds, 1))
    assert batch["names"] == ["v_Test_g01_c01"] and batch["labels"].tolist() == [17]


def test_decode_backend_and_sidecar_dispatch(tmp_path, monkeypatch):
    clip = _u8(4, (3, 8, 10, 3))
    np.save(tmp_path / "a.mp4.npy", clip)
    np.save(tmp_path / "b.npy", clip)
    assert decode.backend() == "native"
    _same(decode.decode_video(str(tmp_path / "b.npy")), clip)
    monkeypatch.setattr(native, "available", lambda: False)
    assert decode.backend() in ("decord", "sidecar")
    _same(decode.decode_video(str(tmp_path / "a.mp4")), clip)
    with pytest.raises(RuntimeError, match="no video decode backend"):
        decode.decode_video(str(tmp_path / "missing.mp4"))


def test_native_build_failure_is_logged_and_the_override_is_honoured(tmp_path, monkeypatch,
                                                                      caplog):
    bad = tmp_path / "broken.cc"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    native._load.cache_clear()
    try:
        with caplog.at_level(logging.WARNING, logger=native.__name__):
            assert not native.available()
        assert "no_such_header_here.h" in caplog.text
        assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "build"))
        monkeypatch.setenv("I2V_TPU_NATIVE_LIB", str(tmp_path / "absent.so"))
        native._load.cache_clear()
        assert not native.available()
        assert not os.path.exists(tmp_path / "absent.so")
    finally:
        native._load.cache_clear()


# -- uint8 ingest and prefetch -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 3), (1, 4, 32, 32, 3)])
def test_ingest_u8_clips_is_bitwise_jax_and_the_f32_path(shape):
    u8 = _u8(5, shape)
    u8[0, 0, 0, :3] = [[0, 0, 0], [255, 255, 255], [1, 128, 254]]
    got = pixel.ingest_u8_clips(u8, "cpu")
    _same(got.numpy(), np.asarray(jpixel.ingest_u8_clips(jnp.asarray(u8))))
    f32 = np.stack([tfm.u8_clip_to_normalized(c) for c in u8])
    _same(got.numpy(), pixel.unnormalize(torch.from_numpy(f32), channel_axis=1).numpy())
    _same(pixel.ingest_u8_clips(torch.from_numpy(u8)).numpy(), got.numpy())
    assert pixel.is_u8_clips(u8) and pixel.is_u8_clips(torch.from_numpy(u8))
    assert not pixel.is_u8_clips(f32) and not pixel.is_u8_clips(u8[0])
    assert not pixel.is_u8_clips(u8.astype(np.int16))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_holds_depth_batches_and_keeps_the_host_copy(depth):
    pulled = []

    def source():
        for i in range(5):
            pulled.append(i)
            yield {"clips": _u8(i, (1, 2, 4, 4, 3)), "labels": np.asarray([i], np.int32)}

    seen = []
    for b in pipeline.device_prefetch(source(), "cpu", depth, keep_host=True):
        i = int(b["labels"][0])
        # depth - 1 batches uploaded beyond the one in the consumer's hands
        assert len(pulled) - 1 - i == min(depth - 1, 4 - i)
        assert isinstance(b["clips"], torch.Tensor) and b["clips"].dtype == torch.uint8
        _same(b["clips"].numpy(), b["clips_host"])
        _same(b["clips_host"], _u8(i, (1, 2, 4, 4, 3)))
        seen.append(i)
    assert seen == list(range(5))
    plain = next(pipeline.device_prefetch(source(), "cpu", depth))
    assert "clips_host" not in plain


def test_make_input_pipeline_is_the_batcher_on_the_device(tmp_path):
    ds, _ = _pair(*_kinetics_files(tmp_path, "npy"), raw_uint8=True)
    want = list(kinetics.iterate_batches(ds, 2, 0, 3))
    got = list(pipeline.make_input_pipeline(ds, 2, kinetics.iterate_batches, left=0, right=3,
                                            device="cpu", prefetch_depth=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same(g["clips"].numpy(), w["clips"])
        assert g["names"] == w["names"] and g["labels"].tolist() == w["labels"].tolist()
