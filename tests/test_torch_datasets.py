"""Port parity of the disk-dataset layer: the PNG codec against Pillow and
OpenCV, ``Settings``, the loaders, both exporters, the rectification maps
and the native loader's rebinding, each against the JAX package (or the
library it reads and writes with) on the same files; and that Settings and
the exporters build on the card unless asked for the CPU.

Tolerances: PNG pixels bit for bit in both directions; Settings' camera
parameters, ``bf`` and masks equal; loader frames equal to the JAX
loaders', trajectories within 1e-6; exported text equal (trajectory
numbers within 1e-6: XLA's float32 sin / cos and PyTorch's differ in the
last bit for some poses, so the shortest-repr text can differ there),
exported images within 1 grey level and depth within one PNG16 step;
rectification maps equal; native decode equal to ``png.py``.
"""

import struct
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.datasets import loaders as jloaders
from nrslam_tpu.datasets import synthetic as jsyn
from nrslam_tpu_torch.datasets import loaders as tloaders
from nrslam_tpu_torch.datasets import png
from nrslam_tpu_torch.datasets import synthetic as tsyn

from torch_parity import np_of

torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")


def _smooth_image(shape, dtype, seed):
    """A textured image whose rows PIL and libpng filter in several ways."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:shape[0], :shape[1]]
    base = 128 + 60 * np.sin(x / 5.0) + 50 * np.cos(y / 7.0)
    img = base[..., None] if len(shape) == 3 else base
    img = img + rng.randint(0, 20, shape)
    if dtype == np.uint16:
        return (np.clip(img, 0, 255) * 257).astype(np.uint16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _row_filters(path) -> list:
    """The filter type of every row of an 8-bit or 16-bit PNG file."""
    data = path.read_bytes()
    width, height, depth, color = struct.unpack(">IIBB", data[16:26])
    stride = width * {0: 1, 2: 3}[color] * depth // 8
    idat, pos = b"", 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    return [raw[y * (stride + 1)] for y in range(height)]


IMAGES = {"gray8": ((60, 80), np.uint8), "rgb8": ((60, 80, 3), np.uint8),
          "gray16": ((60, 80), np.uint16)}


@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_png_against_pillow_and_opencv(kind, tmp_path):
    """png.read of Pillow's and OpenCV's files, and their reads of
    png.write's files, bit for bit."""
    shape, dtype = IMAGES[kind]
    img = _smooth_image(shape, dtype, seed=len(kind))
    Image.fromarray(img).save(tmp_path / "pil.png")
    cv2.imwrite(str(tmp_path / "cv.png"), img[..., ::-1] if img.ndim == 3
                else img)
    png.write(tmp_path / "port.png", img)
    for name in ("pil.png", "cv.png", "port.png"):
        out = png.read(tmp_path / name)
        assert out.dtype == dtype and np.array_equal(out, img), name
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port.png")), img)
    back = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(back[..., ::-1] if img.ndim == 3 else back, img)
    assert set(_row_filters(tmp_path / "port.png")) == {0}
    if kind == "gray8":
        assert set(_row_filters(tmp_path / "pil.png")) >= {1, 2}


def _filtered_png(img: np.ndarray, kinds) -> bytes:
    """An 8-bit gray or RGB PNG whose row y uses filter kinds[y] (the
    forward filters of the PNG specification)."""
    h = img.shape[0]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        k = kinds[y]
        if k == 0:
            pred = np.zeros_like(cur)
        elif k == 1:
            pred = left
        elif k == 2:
            pred = up
        elif k == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([k]) + ((cur - pred) & 0xFF).astype(np.uint8)
                   .tobytes())

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    color = 0 if img.ndim == 2 else 2
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], h, 8,
                                         color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3])
def test_png_reads_every_filter_type(channels, tmp_path):
    """Rows filtered with each of the five filter types (Pillow never picks
    Average, so the file is filtered here) read as Pillow and OpenCV read
    them."""
    shape = (40, 30) if channels == 1 else (40, 30, 3)
    img = _smooth_image(shape, np.uint8, seed=channels)
    kinds = [k % 5 for k in range(40)]
    (tmp_path / "f.png").write_bytes(_filtered_png(img, kinds))
    assert _row_filters(tmp_path / "f.png") == kinds
    assert np.array_equal(png.read(tmp_path / "f.png"), img)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "f.png")), img)
    ref = cv2.imread(str(tmp_path / "f.png"), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(ref[..., ::-1] if channels == 3 else ref, img)


def test_png_gray_and_colour_reads_match_the_jax_loaders(tmp_path):
    """imread_gray / imread_color against the JAX loaders' _imread_gray /
    _imread_color on gray files, and imread_gray of a colour file against
    Pillow's "L" conversion."""
    gray = _smooth_image((30, 40), np.uint8, 3)
    rgb = _smooth_image((30, 40, 3), np.uint8, 4)
    rgb[..., 1] = rgb[..., 1][:, ::-1]
    png.write(tmp_path / "g.png", gray)
    png.write(tmp_path / "c.png", rgb)
    for f in ("g.png", "c.png"):
        assert np.array_equal(png.imread_color(tmp_path / f),
                              jloaders._imread_color(tmp_path / f)), f
    assert np.array_equal(png.imread_gray(tmp_path / "g.png"),
                          jloaders._imread_gray(tmp_path / "g.png"))
    pil_l = np.asarray(Image.open(tmp_path / "c.png").convert("L"),
                       np.float32)
    assert np.array_equal(png.imread_gray(tmp_path / "c.png"), pil_l)


SETTINGS = {
    "pinhole": """%YAML:1.0
Camera.model: "PinHole"
Camera.fx: 472.64955100886374
Camera.fy: 470.5
Camera.cx: 479.5
Camera.cy: 359.5
Camera.radiansPerPixel: 0.002
Stereo.bf: 56.7
System.autoplay: 1
Evaluation.save_path: "out/eval"
MapVisualizer.left_view: !!opencv-matrix
  rows: 4
  cols: 4
""",
    "kb8": """%YAML:1.0
Camera.model: "KannalaBrandt8"
Camera.fx: 383.0
Camera.fy: 383.5
Camera.cx: 63.3
Camera.cy: 47.2
Camera.k0: -0.006
Camera.k1: 0.043
Camera.k2: -0.035
Camera.k3: 0.005
Masking.filterFile: "./filters.txt"
""",
}


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_settings_match_jax(kind, tmp_path):
    """Camera parameters and kind, rad/pixel, bf, paths equal; the kb8 file
    carries a filter file with all three filters (the PredefinedFilter mask
    a PNG beside it), whose masks on one frame equal JAX's."""
    from nrslam_tpu.config import Settings as JSettings
    from nrslam_tpu_torch.config import Settings as TSettings

    (tmp_path / "settings.yaml").write_text(SETTINGS[kind])
    mask = np.zeros((96, 128), np.uint8)
    mask[8:-8, 10:-10] = 255
    png.write(tmp_path / "mask.png", mask)
    (tmp_path / "filters.txt").write_text(
        "BorderFilter 3 5\nBrightFilter 200\nPredefinedFilter mask.png\n")
    js = JSettings(str(tmp_path / "settings.yaml"))
    ts = TSettings(str(tmp_path / "settings.yaml"), device="cpu")
    assert ts.calibration.kind == js.calibration.kind
    np.testing.assert_array_equal(np_of(ts.calibration.params),
                                  np_of(js.calibration.params))
    for f in ("rad_per_pixel", "bf", "autoplay", "evaluation_path",
              "image_visualizer_path", "map_visualizer_path", "raw"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.slam_config(max_points=99)._asdict() == \
        js.slam_config(max_points=99)._asdict()
    if kind == "pinhole":
        assert ts.masker is None and js.masker is None
        return
    frame = _smooth_image((96, 128), np.uint8, 5).astype(np.float32)
    frame[40:50, 60:70] = 255.0
    jm = js.masker.get_all_masks(jnp.asarray(frame))
    tm = ts.masker.get_all_masks(torch.from_numpy(frame))
    assert set(tm) == set(jm) == {"BorderFilter", "BrightFilter",
                                  "PredefinedFilter", "Global"}
    for name in jm:
        assert tm[name].device.type == "cpu"
        np.testing.assert_array_equal(np_of(tm[name]), np_of(jm[name]), name)


@pytest.mark.parametrize("kind", ["settings", "hamlyn", "simulation"])
def test_disk_entry_points_default_to_the_card(kind, tmp_path):
    """Settings (its camera and a PredefinedFilter mask) and both exporters
    build on the card unless asked for the CPU: without a card, device=None
    raises and never falls back; device="cpu" builds on the CPU."""
    from nrslam_tpu_torch.config import Settings
    from nrslam_tpu_torch.datasets import hamlyn_export, simulation_export

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / "settings.yaml").write_text(SETTINGS["kb8"])
    png.write(tmp_path / "mask.png", np.full((12, 16), 255, np.uint8))
    (tmp_path / "filters.txt").write_text("PredefinedFilter mask.png\n")
    scene = tsyn.SceneConfig(height=12, width=16)
    make = {
        "settings": lambda d: Settings(str(tmp_path / "settings.yaml"), d),
        "hamlyn": lambda d: hamlyn_export.export_hamlyn_stereo_dataset(
            tmp_path / "ham", scene, n_frames=2, device=d),
        "simulation": lambda d: simulation_export.export_simulation_dataset(
            tmp_path / "sim", scene, n_frames=2, device=d)}[kind]
    with pytest.raises(RuntimeError, match="CUDA"):
        make(None)
    out = make("cpu")
    if kind == "settings":
        mask = out.masker.get_all_masks(torch.zeros(12, 16))
        assert out.calibration.params.device.type == "cpu"
        assert mask["PredefinedFilter"].device.type == "cpu"
    else:
        assert len(list(out.rglob("*.png"))) >= 4


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Simulation (KB8) and Hamlyn folders written by the JAX exporters and
    by the port's, from the same 60x80 scene."""
    from nrslam_tpu.datasets.hamlyn_export import export_hamlyn_stereo_dataset
    from nrslam_tpu.datasets.simulation_export import \
        export_simulation_dataset
    from nrslam_tpu_torch.datasets import hamlyn_export, simulation_export

    d = tmp_path_factory.mktemp("exported")
    kw = dict(height=60, width=80, deform_amp=0.02, camera_kind="kb8")
    export_simulation_dataset(d / "sim_jax", jsyn.SceneConfig(**kw),
                              n_frames=6)
    simulation_export.export_simulation_dataset(
        d / "sim_port", tsyn.SceneConfig(**kw), n_frames=6, device="cpu")
    kw = dict(height=60, width=80, deform_amp=0.02)
    export_hamlyn_stereo_dataset(d / "ham_jax", jsyn.SceneConfig(**kw),
                                 n_frames=4)
    hamlyn_export.export_hamlyn_stereo_dataset(
        d / "ham_port", tsyn.SceneConfig(**kw), n_frames=4, device="cpu")
    return d


def test_loaders_read_jax_exports_as_jax_does(exported):
    """Simulation: colour frames and depth equal, Tcw within 1e-6; Hamlyn:
    left and right frames equal."""
    js = jloaders.Simulation(str(exported / "sim_jax"))
    ts = tloaders.Simulation(str(exported / "sim_jax"))
    assert len(ts) == len(js) == 6 and len(ts.poses) == 6
    for i in range(6):
        assert np.array_equal(ts.get_image(i), js.get_image(i))
        assert np.array_equal(ts.get_depth_image(i), js.get_depth_image(i))
        Tj, Tt = js.get_camera_pose(i), ts.get_camera_pose(i)
        np.testing.assert_allclose(np_of(Tt.q), np_of(Tj.q), atol=1e-6)
        np.testing.assert_allclose(np_of(Tt.t), np_of(Tj.t), atol=1e-6)
    jh = jloaders.Hamlyn(str(exported / "ham_jax"))
    th = tloaders.Hamlyn(str(exported / "ham_jax"))
    assert len(th) == len(jh) == 4
    for i in range(4):
        assert np.array_equal(th.get_image(i), jh.get_image(i))
        assert np.array_equal(th.get_right_image(i), jh.get_right_image(i))


def test_endomapper_names_txt(exported):
    """The Hamlyn export's names.txt makes the cache an Endomapper dataset
    (endomapper.cc's split-once convention); frames equal JAX's."""
    je = jloaders.Endomapper(str(exported / "ham_port"))
    te = tloaders.Endomapper(str(exported / "ham_port"))
    assert [p.name for p in te.names] == [p.name for p in je.names]
    assert len(te) == 4
    for i in range(4):
        img = te.get_image(i)
        assert img.shape == (60, 80, 3) and img.dtype == np.float32
        assert np.array_equal(img, je.get_image(i))


def test_exporters_write_what_jax_writes(exported):
    """settings.yaml (the KB8 branch's Camera.k0..k3 included),
    filters.txt and names.txt equal to the JAX exporters' text;
    trajectory.csv equal field for field (numbers within 1e-6); frames
    within 1 grey level, depth within one PNG16 step."""
    for a, b, files in (("sim_jax", "sim_port", ("settings.yaml",
                                                 "filters.txt")),
                        ("ham_jax", "ham_port", ("settings.yaml",
                                                 "filters.txt",
                                                 "names.txt"))):
        for f in files:
            assert ((exported / b / f).read_text()
                    == (exported / a / f).read_text()), (b, f)
    assert "Camera.k0: -0.01" in (exported / "sim_port"
                                  / "settings.yaml").read_text()
    rows_j = (exported / "sim_jax" / "trajectory.csv").read_text().split("\n")
    rows_t = (exported / "sim_port" / "trajectory.csv").read_text().split("\n")
    assert len(rows_t) == len(rows_j) and rows_t[0] == rows_j[0]
    for rj, rt in zip(rows_j[1:], rows_t[1:]):
        fj, ft = rj.split(";"), rt.split(";")
        assert len(fj) == len(ft) and fj[-1] == ft[-1]
        if rj:
            np.testing.assert_allclose([float(x) for x in ft],
                                       [float(x) for x in fj], atol=1e-6)
    for sub, pattern in (("rgb", "image_*.png"), ("depth", "aov_image_*.png")):
        names = sorted(p.name for p in (exported / "sim_jax" / sub)
                       .glob(pattern))
        assert names == sorted(p.name for p in (exported / "sim_port" / sub)
                               .glob(pattern)) and len(names) == 6
        for n in names:
            a = png.read(exported / "sim_jax" / sub / n).astype(np.int64)
            b = png.read(exported / "sim_port" / sub / n).astype(np.int64)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, (sub, n)
    for sub in ("images", "images_right"):
        for i in range(4):
            a = png.read(exported / "ham_jax" / sub / f"{i:06d}.png")
            b = png.read(exported / "ham_port" / sub / f"{i:06d}.png")
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, (sub, i)


def test_opencv_only_paths_raise_without_opencv(exported, monkeypatch):
    """Video split and EXR decode need OpenCV, and say so where it is
    missing; PNG reading does not."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        tloaders.Hamlyn.prepare("seq.avi", str(exported / "split"))
    (exported / "exr" / "depth").mkdir(parents=True)
    (exported / "exr" / "depth" / "aov_image_0000.exr").write_bytes(b"")
    with pytest.raises(RuntimeError, match="OpenCV"):
        tloaders.Simulation(str(exported / "exr")).get_depth_image(0)
    assert tloaders.Hamlyn(str(exported / "ham_port")).get_image(0).shape \
        == (60, 80)


def test_rectification_maps_match_jax():
    """The transcribed Hamlyn calibrations and OpenCV's maps, equal."""
    from nrslam_tpu.datasets import rectification as jr
    from nrslam_tpu_torch.datasets import rectification as tr

    for name in ("hamlyn_01", "hamlyn_20"):
        jc, tc = jr.CALIBRATIONS[name], tr.CALIBRATIONS[name]
        for a, b in zip(jc, tc):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert tr.rectified_size(tc) == jr.rectified_size(jc)
        for a, b in zip(jr.rectify_maps(jc), tr.rectify_maps(tc)):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(y, x)
    left = _smooth_image((240, 320), np.uint8, 7)
    jl, jrr, jfx, jbf = jr.rectify_pair(jr.HAMLYN_01, left, left[:, ::-1])
    tl, trr, tfx, tbf = tr.rectify_pair(tr.HAMLYN_01, left, left[:, ::-1])
    assert np.array_equal(tl, jl) and np.array_equal(trr, jrr)
    assert (tfx, tbf) == (jfx, jbf)


def test_native_loader_matches_png(exported):
    """The rebinding of native/dataloader.cc (built into the port's build
    directory) decodes exported gray frames as png.py does, and colour
    frames as the port's RGB -> gray conversion of png.py's colour read."""
    from nrslam_tpu_torch.datasets import native_loader
    from nrslam_tpu_torch.ops import image as image_ops

    if not native_loader.available():
        pytest.skip("native loader does not build here (g++, libpng, "
                    "libjpeg)")
    gray = sorted((exported / "ham_port" / "images").glob("*.png"))
    rgb = sorted((exported / "sim_port" / "rgb").glob("*.png"))
    with native_loader.PrefetchLoader([str(p) for p in gray], n_threads=2,
                                      capacity=2) as frames:
        frames = list(frames)
    assert len(frames) == len(gray)
    for p, f in zip(gray, frames):
        assert np.array_equal(f, png.imread_gray(p))
    for p in rgb:
        ref = image_ops.rgb_to_gray(torch.from_numpy(png.imread_color(p)))
        assert np.array_equal(native_loader.decode(str(p)), ref.numpy())
    assert native_loader.decode(str(exported / "missing.png")) is None
