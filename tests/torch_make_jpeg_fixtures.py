"""Writes ``tests/torch_jpeg/``: small JPEGs with cv2's decodes of them, and
a PNG with cv2's default encoding of it, so that the port's JPEG codec
(``gsplat_tpu_torch/csrc/jpeg_codec.cpp``) can be held to cv2 where cv2 is
not installed (the tier-1 tests, the card's machine).

    python tests/torch_make_jpeg_fixtures.py     # needs cv2 and PIL

Each ``<name>.jpg`` has ``<name>.png``, ``cv2.imread``'s decode of it (as
RGB); ``enc_src.png`` has ``enc_src.jpg``, the bytes of ``cv2.imwrite``'s
defaults.  ``check(folder)`` holds the codec to them and imports neither
cv2 nor PIL.
"""

from __future__ import annotations

import os
import sys

import numpy as np

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_jpeg")
# name -> (height, width, cv2 imwrite parameters by name)
CASES = {
    "baseline_420": (45, 61, {}),
    "baseline_444": (45, 61, {"SAMPLING_FACTOR": "444", "QUALITY": 90}),
    "progressive": (45, 61, {"PROGRESSIVE": 1, "QUALITY": 85}),
    "restart": (45, 61, {"RST_INTERVAL": 2, "QUALITY": 75}),
    "gray": (17, 29, {"QUALITY": 80}),
    "exif_6": (40, 60, None),        # orientation 6, written with PIL
}


def fixture_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A smooth (H, W, 3) uint8 image with light noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 7 + y / 11),
                    128 + 90 * np.cos(x / 5 - y / 9),
                    128 + 80 * np.sin((x + y) / 13)], axis=2)
    img += rng.normal(0, 6, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def generate(folder: str = FOLDER):
    import cv2
    from PIL import Image

    from gsplat_tpu_torch.utils.image_io import write_png

    os.makedirs(folder, exist_ok=True)
    for i, (name, (h, w, params)) in enumerate(CASES.items()):
        img = fixture_image(h, w, seed=i)
        path = os.path.join(folder, f"{name}.jpg")
        if params is None:
            exif = Image.Exif()
            exif[0x0112] = 6
            Image.fromarray(img).save(path, exif=exif.tobytes(), quality=90)
        else:
            flags = []
            for k, v in params.items():
                if k == "SAMPLING_FACTOR":
                    v = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{v}")
                flags += [getattr(cv2, f"IMWRITE_JPEG_{k}"), v]
            src = img[..., 0] if name == "gray" else img[..., ::-1]
            cv2.imwrite(path, src, flags)
        write_png(os.path.join(folder, f"{name}.png"),
                  np.ascontiguousarray(cv2.imread(path)[..., ::-1]))
    img = fixture_image(37, 53, seed=len(CASES))
    write_png(os.path.join(folder, "enc_src.png"), img)
    cv2.imwrite(os.path.join(folder, "enc_src.jpg"), img[..., ::-1])


def check(folder: str = FOLDER, scratch: str | None = None) -> dict:
    """The codec against the committed outputs: name -> True where the
    decode is bit for bit cv2's (``enc_src``: the encoding byte for byte).
    ``scratch`` is a directory for the encoder's file (a temporary one by
    default)."""
    import tempfile

    from gsplat_tpu_torch.utils.image_io import read_jpeg, read_png, \
        write_jpeg

    out = {}
    for name in CASES:
        got = read_jpeg(os.path.join(folder, f"{name}.jpg"))
        want = read_png(os.path.join(folder, f"{name}.png"))
        out[name] = got.shape == want.shape and bool((got == want).all())
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        path = os.path.join(tmp, "enc_src.jpg")
        write_jpeg(path, read_png(os.path.join(folder, "enc_src.png")))
        with open(path, "rb") as f, \
                open(os.path.join(folder, "enc_src.jpg"), "rb") as g:
            out["enc_src"] = f.read() == g.read()
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    generate()
    print(check())
