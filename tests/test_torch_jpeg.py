"""The port's JPEG codec (`sfa3d_tpu_torch/data/jpeg.py`) against cv2 5.0
(libjpeg-turbo 3.1) on seeded images, and the PNG/JPEG image helpers of
`data/png.py`.

Tolerances: none. The decoder's pixels equal `cv2.imdecode`'s on cv2's
own files at quality 50, 75 and 95, 4:4:4, 4:2:2, 4:4:0 and 4:2:0, greyscale,
restart intervals and sizes 1 x 1 to 375 x 1242; the encoder's bytes equal
`cv2.imencode`'s at the defaults and at quality 75 and 50, on noise and on
a drawn frame (the encoder writes cv2's default layout only: 4:2:0, no
restart markers). The round trip of a seeded image is pinned by its digest,
which `chip_smoke.py` checks on the card machine's numpy.
"""

import hashlib

import cv2
import numpy as np
import pytest

from sfa3d_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
# sha256 of encode_jpeg(x) + decode_jpeg(encode_jpeg(x)).tobytes() for
# x = round_trip_image(); chip_smoke.py holds the same value
ROUND_TRIP_SHA256 = "6c674e0284df81b0ed36acf9e3f2468a2174e2752cf42ad852487dad33aeaf68"


def round_trip_image() -> np.ndarray:
    """A seeded 96 x 160 BGR frame: a gradient with noise and a bright box."""
    rng = np.random.default_rng(14)
    y, x = np.mgrid[0:96, 0:160]
    img = np.stack([x * 1.5, y * 2.5, (x + y) * 0.8], axis=-1) + rng.normal(0, 4, (96, 160, 3))
    img[30:60, 50:90] = (20, 220, 250)
    return np.clip(img, 0, 255).astype(np.uint8)


def _noise(h, w, seed, channels=3):
    shape = (h, w, channels) if channels > 1 else (h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _drawn_frame():
    """A synthetic camera frame (375 x 1242) with a drawn label, BGR."""
    from sfa3d_tpu_torch.config import kitti as cnf
    from sfa3d_tpu_torch.data.synthetic import render_camera_image, synthetic_scene
    from sfa3d_tpu_torch.viz import raster

    points, labels = synthetic_scene(seed=3)
    img = np.ascontiguousarray(render_camera_image(points, labels, np.asarray(cnf.P2)[:3])[:, :, ::-1])
    raster.rectangle(img, (100, 80), (300, 200), (0, 255, 255), 2)
    raster.put_text(img, "Fused car 0.87", (100, 75), raster.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 255), 1)
    return img


def _cv2_encode(img, *params):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _assert_decodes_like_cv2(data: bytes):
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33)])
@pytest.mark.parametrize("sampling", ["444", "422", "440", "420"])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_decoder_equals_cv2(size, sampling, quality):
    img = _noise(*size, seed=size[0] * 100 + quality)
    _assert_decodes_like_cv2(_cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]))


@pytest.mark.parametrize("quality", [75, 95])
def test_decoder_equals_cv2_on_a_full_frame(quality):
    _assert_decodes_like_cv2(_cv2_encode(_drawn_frame(), cv2.IMWRITE_JPEG_QUALITY, quality))


@pytest.mark.parametrize("size", [(7, 9), (40, 66)])
def test_decoder_equals_cv2_in_greyscale(size):
    _assert_decodes_like_cv2(_cv2_encode(_noise(*size, seed=5, channels=1)))


@pytest.mark.parametrize("interval", [1, 3])
def test_decoder_equals_cv2_with_restart_intervals(interval):
    _assert_decodes_like_cv2(_cv2_encode(_noise(40, 70, seed=6), cv2.IMWRITE_JPEG_RST_INTERVAL, interval))


def test_decoder_uses_the_standard_tables_without_dht():
    """An MJPEG-style frame with its DHT segments removed decodes as cv2
    decodes the complete file."""
    data = _cv2_encode(_noise(24, 40, seed=7))
    out, pos = [data[:2]], 2
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xC4:
            out.append(data[pos:pos + 2 + length])
        pos += 2 + length
    stripped = b"".join(out) + data[pos:]
    assert b"\xff\xc4" not in stripped[:pos]
    np.testing.assert_array_equal(decode_jpeg(stripped), cv2.imdecode(np.frombuffer(data, np.uint8), 1))


def test_decoder_refuses_other_processes():
    img = _noise(16, 16, seed=8)
    with pytest.raises(ValueError, match="SOF2 .progressive"):
        decode_jpeg(_cv2_encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    data = bytearray(_cv2_encode(img))
    sof = data.index(b"\xff\xc0")
    lossless = bytes(data[:sof + 1]) + b"\xc3" + bytes(data[sof + 2:])
    with pytest.raises(ValueError, match="SOF3 .lossless"):
        decode_jpeg(lossless)
    data[sof + 4] = 12  # the sample precision
    with pytest.raises(ValueError, match="12-bit"):
        decode_jpeg(bytes(data))


@pytest.mark.parametrize("quality", [95, 75, 50])
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (120, 192)])
def test_encoder_bytes_equal_cv2_on_noise(size, quality):
    img = _noise(*size, seed=size[1] + quality)
    params = [] if quality == 95 else [cv2.IMWRITE_JPEG_QUALITY, quality]
    assert encode_jpeg(img, quality) == _cv2_encode(img, *params)


@pytest.mark.parametrize("quality", [95, 75, 50])
def test_encoder_bytes_equal_cv2_on_a_drawn_frame(quality):
    img = _drawn_frame()
    assert encode_jpeg(img, quality) == _cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality)


def test_decoder_takes_rgb_components_as_libjpeg_does():
    """Without JFIF, components named R, G, B are RGB (no colour
    transform), as libjpeg's default_decompress_parms decides."""
    data = bytearray(_cv2_encode(_noise(16, 24, seed=11), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"]))
    app0 = data.index(b"\xff\xe0")
    del data[app0:app0 + 2 + int.from_bytes(data[app0 + 2:app0 + 4], "big")]
    sof, sos = data.index(b"\xff\xc0"), data.index(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        data[sof + 10 + 3 * k] = cid
        data[sos + 5 + 2 * k] = cid
    _assert_decodes_like_cv2(bytes(data))


def test_round_trip_digest_is_pinned():
    x = round_trip_image()
    data = encode_jpeg(x)
    y = decode_jpeg(data)
    np.testing.assert_array_equal(y, cv2.imdecode(np.frombuffer(data, np.uint8), 1))
    assert hashlib.sha256(data + y.tobytes()).hexdigest() == ROUND_TRIP_SHA256
    assert 30 < 10 * np.log10(255.0 ** 2 / np.mean((y.astype(float) - x) ** 2))  # PSNR, dB


def test_image_helpers_pick_the_codec(tmp_path):
    from sfa3d_tpu_torch.data.png import read_image_bgr, write_image_bgr

    img = _noise(20, 30, seed=10)
    write_image_bgr(str(tmp_path / "a.png"), img)
    write_image_bgr(str(tmp_path / "a.jpg"), img)
    np.testing.assert_array_equal(read_image_bgr(str(tmp_path / "a.png")), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")), img)
    assert (tmp_path / "a.jpg").read_bytes() == _cv2_encode(img)
    np.testing.assert_array_equal(read_image_bgr(str(tmp_path / "a.jpg")), cv2.imread(str(tmp_path / "a.jpg")))
    (tmp_path / "b.png").write_bytes((tmp_path / "a.jpg").read_bytes())  # sniffed, not named
    np.testing.assert_array_equal(read_image_bgr(str(tmp_path / "b.png")), cv2.imread(str(tmp_path / "a.jpg")))
    with pytest.raises(ValueError, match="extension"):
        write_image_bgr(str(tmp_path / "a.bmp"), img)
