"""Writes ``tests/torch_images/``: small image files of every kind the
port's readers take beyond plain PNG and JPEG, each with cv2's decode of it,
so that ``utils/image_io.read_image`` can be held to cv2 where cv2 is not
installed (the tier-1 tests, the card's machine).

    python tests/torch_make_image_fixtures.py          # needs cv2, PIL,
                                                       # gcc, the system
                                                       # libjpeg and libwebp
    python tests/torch_make_image_fixtures.py --webp   # the WebP ones alone
    python tests/torch_make_image_fixtures.py --raster # GIF, HDR, PFM, PAM,
                                                       # Sun raster, BigTIFF
    python tests/torch_make_image_fixtures.py --jpeg2000  # JPEG 2000 (also
                                                       # the system
                                                       # libopenjp2)
    python tests/torch_make_image_fixtures.py --pyramid  # cv2's rate-
                                                       # allocated JP2 and
                                                       # INTER_AREA answers
    python tests/torch_make_image_fixtures.py --avif   # AVIF (cv2, PIL)

Each ``<name>.<ext>`` has ``<name>.want.png``, ``cv2.imread``'s decode of
it (as RGB).  ``REFUSED`` names the files cv2 does not read (its
``imread`` gives None): the port must raise naming them.  ``enc_src.png``
has ``enc_src.bmp``, ``enc_src.ppm`` and ``enc_src.tif``, the bytes of
``cv2.imwrite``'s defaults (``enc_j2k.jp2``, of ``enc_j2k_src.png``, its
lossless JPEG 2000: ``ENCODED_J2K``; ``ENCODED_J2K_RATE``: its JP2 at
X1000 250, 100 and 500, and one of ``enc_j2k_src2.png``);
``RESIZED`` holds ``cv2.resize(..., INTER_AREA)`` of ``enc_j2k_src.png``
at fractional and enlarging factors, and ``TIMING_CV2`` the SHA-256s of
cv2's default JP2 bytes and of two resizes of the 1297x840 timing view;
``ROUND_TRIP`` names what the port writes and must read back as
``enc_src.png`` (WebP).  ``AVIF_UNPORTED`` names AVIF files cv2 reads with
a tool the port does not decode yet (it must raise naming them and saying
so), ``TIMING_AVIF`` the SHA-256s of cv2's decodes of the full-size AVIF
views, ``AVIF_MID`` holds cv2's default AVIF copies of the 24 views of
``make_synth_scene`` ``mid`` (seed 0), ``AVIF_MID_SCREEN`` Pillow's
(tune-content=screen, 4:2:2, an alpha item) and ``AVIF_MID_GRAIN``
Pillow's with film grain (libaom's 16 test vectors, then its denoiser),
for chip_smoke's AVIF training legs (``--avif MID_SCENE`` writes the three
from the scene's folder).

The writers: a small C program, built here, over the system libjpeg-turbo
(arithmetic-coded JPEG with DAC conditioning, YCCK, 2 components) and over
Pillow's bundled libjpeg-turbo 3 (lossless and 12-bit JPEG); another over
the system libwebp's encoder (lossy WebP options cv2 and PIL do not
expose, palettes, alpha); ctypes over the system libopenjp2's encoder
(JPEG 2000 code-block styles, POC, ROI, tile-parts, TLM, SOP/EPH,
precisions, signed and subsampled components); PIL (CMYK JPEG, BMP,
lossless WebP, JPEG 2000);
``cv2.imwrite`` (TIFF compressions, 16-bit TIFF, BMP, PNM, WebP); bytes
written here (Adam7 PNG, tiled / planar / big-endian / palette TIFF, RLE
BMP, PNM text files, a hierarchical frame, WebP containers: VP8X, ALPH,
EXIF, ICCP, ANIM / ANMF; JP2 boxes: pclr, cmap, cdef, colr) and cuts and
corruptions of the files written.
``check(folder)`` imports neither cv2 nor PIL.
"""

from __future__ import annotations

import os
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy as np

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_images")
H, W = 29, 38                       # fixture size: whole and partial MCUs

# name -> file; every file but those of REFUSED has <name>.want.png
CASES = [
    # JPEG
    "jpeg_cut_baseline.jpg", "jpeg_cut_prog_30.jpg", "jpeg_cut_prog_60.jpg",
    "jpeg_cut_prog_90.jpg", "jpeg_arith_seq.jpg", "jpeg_arith_prog.jpg",
    "jpeg_cmyk.jpg", "jpeg_ycck.jpg", "jpeg_lossless_p1.jpg",
    "jpeg_lossless_p7_pt2.jpg", "jpeg_lossless_cmyk.jpg",
    # interlaced PNG
    "png_adam7_rgb8.png", "png_adam7_rgb16.png", "png_adam7_palette.png",
    "png_adam7_gray2.png",
    # TIFF
    "tiff_none.tif", "tiff_lzw.tif", "tiff_deflate.tif",
    "tiff_adobe_deflate.tif", "tiff_packbits.tif", "tiff_lzw_16.tif",
    "tiff_gray_pred.tif", "tiff_tiled.tif", "tiff_planar.tif",
    "tiff_big_endian.tif", "tiff_palette.tif", "tiff_gray.tif",
    "tiff_bilevel.tif", "tiff_rgba_unassoc.tif", "tiff_jpeg.tif",
    "tiff_jpeg_ycbcr.tif",
    # BMP
    "bmp_pal8.bmp", "bmp_rle8.bmp", "bmp_rle4.bmp", "bmp_pal1.bmp",
    "bmp_24.bmp", "bmp_32.bmp", "bmp_565.bmp", "bmp_top_down.bmp",
    # PNM
    "pnm_p1.pbm", "pnm_p4.pbm",
    *[f"pnm_{kind}_{maxval}.{'pgm' if kind in ('p2', 'p5') else 'ppm'}"
      for kind in ("p2", "p3", "p5", "p6") for maxval in (255, 7, 1000)],
    # WebP
    "webp_lossless.webp", "webp_lossless_m6.webp", "webp_lossless_pal2.webp",
    "webp_lossless_pal4.webp", "webp_lossless_pal16.webp",
    "webp_lossless_pal256.webp", "webp_lossless_alpha.webp",
    "webp_near_lossless.webp", "webp_lossy.webp", "webp_lossy_parts4.webp",
    "webp_lossy_simple_filter.webp", "webp_lossy_no_filter.webp",
    "webp_lossy_sharp_yuv.webp", "webp_lossy_alpha_raw.webp",
    "webp_lossy_alpha_lossless.webp", "webp_lossy_alpha_gradient.webp",
    "webp_exif_orientation6.webp", "webp_iccp.webp",
    "webp_animated_offset.webp",
    # GIF
    *[f"gif_table{n}.gif" for n in (2, 4, 8, 16, 32, 64, 128, 256)],
    "gif_table4_mcs8.gif", "gif87a.gif", "gif_interlaced.gif",
    "gif_pil_interlaced.gif", "gif_animated.gif", "gif_pil_transparent.gif",
    "gif_transparent_bg.gif", "gif_offset_frame.gif", "gif_local_table.gif",
    "gif_local_small.gif", "gif_local_only.gif", "gif_no_table.gif",
    "gif_deferred_clear.gif", "gif_cleared_when_full.gif",
    "gif_end_code_inside.gif", "gif_no_end_code.gif",
    "gif_one_byte_blocks.gif", "gif_extensions.gif",
    "gif_code_after_frame.gif", "gif_cv2.gif",
    # Radiance HDR
    "hdr_rle.hdr", "hdr_narrow.pic", "hdr_flat.hdr", "hdr_values.hdr",
    "hdr_rgbe_header.hdr", "hdr_rle_then_flat.hdr", "hdr_flat_wide.hdr",
    # PFM
    "pfm_cv2.pfm", "pfm_specials.pfm", "pfm_big_endian.pfm", "pfm_scale.pfm",
    # PAM
    "pam_cv2.pam", "pam_rgb.pam", "pam_rgb_notype.pam", "pam_gray.pam",
    "pam_bw.pam", "pam_bw_notype.pam", "pam_rgb16.pam", "pam_gray1000.pam",
    "pam_ga_width1.pam", "pam_rgba_width1.pam", "pam_header_order.pam",
    # Sun raster
    "ras_cv2.ras", "ras_old_type.ras", "ras_32.ras", "ras_8_gray.ras",
    "ras_8_map.ras", "ras_8_short_map.ras", "ras_1.ras", "ras_1_map.ras",
    # BigTIFF
    "bigtiff_pil.tif", "bigtiff_lzw.tif", "bigtiff_tiled.tif",
    "bigtiff_planar.tif", "bigtiff_be16.tif", "bigtiff_packbits.tif",
    "bigtiff_jpeg.tif",
]
REFUSED = ["jpeg_12bit.jpg", "jpeg_hierarchical.jpg", "jpeg_2comp.jpg",
           "jpeg_lossless_gray.jpg", "tiff_gray_alpha.tif",
           "tiff_palette2.tif", "webp_cut.webp", "webp_chunk_past_riff.webp",
           "webp_bad_alph.webp", "webp_frame_outside_canvas.webp",
           "gif_cut_trailer.gif", "gif_cut_data.gif", "gif_short_data.gif",
           "gif_data_past_frame.gif", "gif_code_past_table.gif",
           "gif_mcs12.gif", "gif_frame_outside.gif",
           "gif_index_past_table.gif", "gif_disposal4.gif",
           "gif_gce_size5.gif", "gif_bg_past_table.gif",
           "gif_version88a.gif", "hdr_plus_y.hdr", "hdr_xyze.hdr",
           "hdr_cut.hdr", "hdr_wrong_width.hdr", "hdr_bad_run.hdr",
           "pfm_gray.pfm", "pfm_scale0.pfm", "pfm_cut.pfm",
           "pfm_space_magic.pfm", "pam_unknown_field.pam",
           "pam_width_twice.pam", "pam_depth_mismatch.pam",
           "pam_maxval65536.pam", "pam_plus_width.pam", "pam_cut.pam",
           "ras_byte_encoded.ras", "ras_rgb_type.ras", "ras_depth4.ras",
           "ras_cut.ras", "bigtiff_offsets4.tif"]
# read by cv2, refused by the port: cv2 fills only part of each row of a
# GRAYSCALE_ALPHA or RGB_ALPHA PAM wider than one pixel
GARBLED = ["pam_ga_wide.pam", "pam_rgba_wide.pam"]
ENCODED = ["enc_src.bmp", "enc_src.ppm", "enc_src.tif", "enc_src.gif",
           "enc_src.hdr", "enc_src.pfm", "enc_src.pam", "enc_src.ras"]
# written by the port and read back (the WebP writer is held to pixels,
# not to cv2's bytes: libwebp's lossless encoder searches its options)
ROUND_TRIP = ["enc_src.webp"]
# a full-size view for the decode seconds of an arithmetic-coded JPEG
# (chip_smoke.py); no decode beside it, the tests hold it to cv2
TIMING = "timing_arith_1297x840.jpg"
# the same view through cv2.imwrite at IMWRITE_WEBP_QUALITY 90, and the
# SHA-256 of cv2's decode of it (RGB, row-major bytes)
TIMING_WEBP = "timing_lossy_1297x840.webp"
TIMING_WEBP_SHA256 = ("92e73568b2ca4c0d9cb0eff6028f7e05"
                      "6f6712ac41c261c4264e8593f9dcf279")


# --------------------------------------------------------------- JPEG 2000


# what cv2 5.0.0 reads; the JPEG 2000 files are made here, cv2 is the
# oracle of their decode (see generate_jpeg2000)
J2K_CASES = [
    "j2k_cv2_lossless.jp2", "j2k_cv2_default.jp2", "j2k_cv2_x50.jp2",
    "j2k_pil_rgb.jp2", "j2k_pil_97_layers.jp2", "j2k_pil_raw.j2k",
    "j2k_pil_gray.jp2", "j2k_pil_rgba.jp2", "j2k_pil_gray16.jp2",
    "j2k_pil_la.jp2", "j2k_bypass.j2k", "j2k_reset_termall.j2k",
    "j2k_vsc_segsym.j2k", "j2k_pterm.j2k", "j2k_all_styles_97.j2k",
    "j2k_roi.j2k", "j2k_poc.j2k", "j2k_tile_parts.j2k", "j2k_tlm.j2k",
    "j2k_sop_eph.j2k", "j2k_prec12.j2k", "j2k_cblk_4x64.j2k",
    "j2k_ppt.j2k", "j2k_ppm.j2k",
    "j2k_pclr.jp2", "j2k_cdef_alpha_first.jp2", "j2k_sycc.jp2",
    "j2k_icc.jp2", "j2k_gray_colr_rgb.jp2",
]
J2K_REFUSED = [
    "j2k_raw_gray.j2k", "j2k_signed.j2k", "j2k_offset.j2k",
    "j2k_cut_60.jp2", "j2k_5comp.j2k", "j2k_prec4.j2k",
    "j2k_subsampled.j2k", "j2k_cmyk.jp2", "j2k_rgb_2comp.jp2",
]
CASES += J2K_CASES
REFUSED += J2K_REFUSED
# write_jpeg2000's bytes against cv2's lossless JP2 of ENCODED_J2K_SRC
# (cv2's writer needs 32 pixels a side, more than enc_src.png has)
ENCODED_J2K = ["enc_j2k.jp2"]
ENCODED_J2K_SRC = "enc_j2k_src.png"
# two full-size views of TIMING for chip_smoke's decode seconds, and the
# SHA-256 of cv2's decode of each (RGB, row-major bytes): cv2's writer at
# IMWRITE_JPEG2000_COMPRESSION_X1000 50 (reversible, cut by OpenJPEG's rate
# allocation: truncated passes, mid-point reconstruction), and the 9/7
# transform in 3 layers, RPCL, 512x512 tiles, 128x128 precincts, SOP, EPH
# and PLT through the system libopenjp2
TIMING_J2K = {
    "timing_rate_1297x840.jp2": ("c31b47cabab35c8140ea000954ca2e06"
                                 "fdb74fb239357d905801f7f790d86f30"),
    "timing_97_1297x840.jp2": ("d81864d67a28513cc4fbb153c806a93c"
                               "47f20df69f49885e450f4be40dd48ebf"),
}

# -------------------------------------------------------------- pyramid

# write_jpeg2000's bytes against cv2's at OpenJPEG's rate allocation: name
# -> (its source, IMWRITE_JPEG2000_COMPRESSION_X1000); 250 is cv2's
# default, and enc_j2k_x500.jp2's source is one where OpenJPEG 2.5.0 (the
# system library) and 2.5.3 (cv2's) keep different coding passes
ENCODED_J2K_RATE = {"enc_j2k_x250.jp2": (ENCODED_J2K_SRC, 250),
                    "enc_j2k_x100.jp2": (ENCODED_J2K_SRC, 100),
                    "enc_j2k_x500.jp2": ("enc_j2k_src2.png", 500)}
# downsample_area against cv2.resize(RESIZE_SRC, None, fx=1/f, fy=1/f,
# interpolation=INTER_AREA): name -> f (fractional shrinks, enlargements)
RESIZE_SRC = ENCODED_J2K_SRC
RESIZED = {"area_f1.5.png": 1.5, "area_f2.25.png": 2.25,
           "area_f1.43.png": 1 / 0.7, "area_f3.3.png": 3.3,
           "area_f0.5.png": 0.5, "area_f0.75.png": 0.75,
           "area_f0.3.png": 0.3}
# the same at full size, on TIMING's decode: the SHA-256 of cv2's default
# JP2 bytes (rate 4) and of cv2.resize's pixels (RGB, row-major) at 1.5
# and 0.5
TIMING_CV2 = {
    "timing_default.jp2": ("06fdcf7640e733bdb9a0d7cb679d7b6a"
                           "5d8704fd0a82a4155b8d28590d84ed3d"),
    "timing_area_f1.5.png": ("b0d4340284a2bd81cea4bfad31c758c6"
                             "82602767001b4ef64e2048ea39d38742"),
    "timing_area_f0.5.png": ("ce10c062603fee58f827a90307287524"
                             "fa9814fab6da3fbaa01f5d4241d486a4"),
}

# -------------------------------------------------------------------- AVIF

# cv2's AVIF writer (libavif 1.4.2 over libaom 3.14.1): its default
# (quality 50), quality 90, lossless (100), 10 and 12 bits, and sizes down
# to 1x1; Pillow's through libaom's options (4:4:4, 128x128 superblocks,
# CDEF and quantizer matrices on); an unknown property not marked essential;
# Pillow's 4:2:2, 4:0:0 and RGBA (an alpha item), flat blocks of a few
# colours under tune-content=screen (palette) and text-like rows (palette
# and intra block copy); film grain (libaom's test vector 1, its denoiser,
# and test vector 9 in an RGBA file's colour and alpha); grids of cv2's
# tiles (2x2 of 4:2:0, a 3x1 of 4:4:4 with a grid alpha of Pillow's grain
# tiles)
AVIF_CASES = [
    "avif_cv2_default.avif", "avif_cv2_q90.avif", "avif_cv2_lossless.avif",
    "avif_cv2_d10.avif", "avif_cv2_d12.avif", "avif_cv2_1x1.avif",
    "avif_cv2_3x5.avif", "avif_cv2_17x33.avif", "avif_cv2_130x67.avif",
    "avif_pil_444.avif", "avif_pil_sb128.avif", "avif_pil_cdef_qm.avif",
    "avif_unknown_property.avif", "avif_pil_422.avif", "avif_pil_400.avif",
    "avif_pil_alpha.avif", "avif_pil_palette.avif",
    "avif_pil_intrabc.avif", "avif_pil_grain.avif", "avif_pil_denoise.avif",
    "avif_pil_grain_alpha.avif", "avif_grid.avif", "avif_grid_alpha.avif",
]
# libavif refuses: no ispe, an item past the end of the file, an unknown
# essential property, a file cut short; libaom's grain checks (15 luma
# scaling points) and libavif's grid rules (a 2x2 grid of 3 tiles)
AVIF_REFUSED = ["avif_no_ispe.avif", "avif_iloc_past_end.avif",
                "avif_essential_unknown.avif", "avif_cut.avif",
                "avif_grain_15_points.avif", "avif_grid_3_tiles.avif"]
# cv2 reads it; the port does not yet: a rotation
AVIF_UNPORTED = ["avif_irot.avif"]
CASES += AVIF_CASES
REFUSED += AVIF_REFUSED
# full-size AVIF views for chip_smoke's decode seconds and the SHA-256 of
# cv2's decode of each (RGB, row-major bytes): TIMING by cv2 at its
# default, at 10 and 12 bits (from TIMING * 257 as uint16), a lossless
# 320x208 crop of it, and Pillow's 4x2 tiles and 4:4:4 lossy; Pillow's
# tune-content=screen of TIMING under a 320-row band of text-like glyphs
# (palette and intra block copy), its 4:2:2 and 4:0:0, and TIMING with
# SCREEN_ALPHA as an alpha item; Pillow's film grain (libaom's test vector
# 1) and denoiser (noise level 25) at its default quality, and a 3x2 grid
# of Pillow's 4:4:4 tiles of 433x420
TIMING_AVIF = {
    "timing_default_1297x840.avif": ("bfd7f5cfbcc1f8e6d44dba6fdc4ccc94"
                                     "6cbe3178ace04890bffad5c2baaf1a2c"),
    "timing_d10_1297x840.avif": ("403273e7d95518516d5885524ba374bf"
                                 "41ab23e9a12ef4d6acbf1d4bb9a7cd37"),
    "timing_d12_1297x840.avif": ("785671f5201c43d621936a3ffa1479d7"
                                 "86749dc9944d64f5ad803a5e262d9979"),
    "timing_lossless_320x208.avif": ("04148d52351277e0b217d5404638c4b2"
                                     "d9eabdb46da0c5e0ad41193d74cf5896"),
    "timing_tiles_1297x840.avif": ("6beb4788f222f12f31438b39d1bb2d6b"
                                   "9c13dce8e1df6f2019ddc913131e27be"),
    "timing_444_1297x840.avif": ("cb8400f85c88678d8f2bfc91c7fb0db3"
                                 "8eb27d010446d48a4a9a92888ae50d4c"),
    "timing_screen_1297x840.avif": ("eee79eb13752b48a2fb99df5e548a558"
                                    "266d4bdea54463d5d80f0bf4e3101b3e"),
    "timing_422_1297x840.avif": ("438da6f5cfecb7a565ed02dd948db377"
                                 "8f75507e392cef0372fe6a1aedc8eba1"),
    "timing_400_1297x840.avif": ("f0b1c32b47588c96e77cbdcf1f0a5644"
                                 "e0291a34ab56fe48877c4b2e2b502476"),
    "timing_alpha_1297x840.avif": ("127eac07f5789c01fb9aa2a6e8b9459b"
                                   "71a900963f2b1fbdb9b1ad5adb078b70"),
    "timing_grain_1297x840.avif": ("35ef19fd17df6a60472dce192d368181"
                                   "c48cdfe221142f09254b5fd9a96bd6b2"),
    "timing_denoise_1297x840.avif": ("3f817b313b77b2b94306f6e5a4e312ce"
                                     "0056ddbc19abf2d845c0b25eef2b3c9c"),
    "timing_grid_1297x840.avif": ("6a9dcc009e160045f293cbb533cd2a52"
                                  "fa6f0905ca0acb5a1850a873b7ea14fd"),
}
# cv2's default AVIF copies of make_synth_scene --preset mid's 24 views
AVIF_MID = "avif_mid"
# Pillow's copies of the same views with film grain: views 0-15 libaom's
# test vectors 1-16, the rest its denoiser at AVIF_DENOISE
AVIF_MID_GRAIN = "avif_mid_grain"
AVIF_DENOISE = "25"
# Pillow's copies of the same views with tune-content=screen, 4:2:2 and
# SCREEN_ALPHA as an alpha item
AVIF_MID_SCREEN = "avif_mid_screen"
AVIF_SCREEN_OPTS = dict(subsampling="4:2:2",
                        advanced={"tune-content": "screen"})


def screen_alpha(h: int, w: int) -> np.ndarray:
    """(h, w) uint8: the alpha plane of the RGBA views, a diagonal ramp."""
    y, x = np.mgrid[:h, :w]
    return ((x + 2 * y) * 255 // max(w - 1 + 2 * (h - 1), 1)).astype(
        np.uint8)


def screen_view(view: np.ndarray) -> np.ndarray:
    """The BGR view with its top 320 rows replaced by text-like glyphs."""
    import torch_avif_oracles as oracle

    out = view.copy()
    band = min(320, view.shape[0])
    out[:band] = oracle.screen_image("text", band, view.shape[1],
                                     np.random.default_rng(18))
    return out

_OPJ_LIB = "libopenjp2.so.7"
_OPJ_PROG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


def _opj_types():
    """openjpeg.h (2.5)'s encoder structures for ctypes."""
    import ctypes as c

    u32, i32 = c.c_uint32, c.c_int32

    class Poc(c.Structure):
        _fields_ = [(n, u32) for n in ("resno0", "compno0", "layno1",
                                       "resno1", "compno1", "layno0",
                                       "precno0", "precno1")] + \
            [("prg1", c.c_int), ("prg", c.c_int), ("progorder", c.c_char * 5),
             ("tile", u32)] + \
            [(n, i32) for n in ("tx0", "tx1", "ty0", "ty1")] \
            + [(n, u32) for n in (
                "layS", "resS", "compS", "prcS", "layE", "resE", "compE",
                "prcE", "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t",
                "res_t", "comp_t", "prc_t", "tx0_t", "ty0_t")]

    ci = c.c_int
    path = c.c_char * 4096

    class Params(c.Structure):
        _fields_ = [
            ("tile_size_on", ci), ("cp_tx0", ci), ("cp_ty0", ci),
            ("cp_tdx", ci), ("cp_tdy", ci), ("cp_disto_alloc", ci),
            ("cp_fixed_alloc", ci), ("cp_fixed_quality", ci),
            ("cp_matrice", c.c_void_p), ("cp_comment", c.c_char_p),
            ("csty", ci), ("prog_order", ci), ("POC", Poc * 32),
            ("numpocs", u32), ("tcp_numlayers", ci),
            ("tcp_rates", c.c_float * 100),
            ("tcp_distoratio", c.c_float * 100),
            ("numresolution", ci), ("cblockw_init", ci),
            ("cblockh_init", ci), ("mode", ci), ("irreversible", ci),
            ("roi_compno", ci), ("roi_shift", ci), ("res_spec", ci),
            ("prcw_init", ci * 33), ("prch_init", ci * 33), ("infile", path),
            ("outfile", path), ("index_on", ci), ("index", path),
            ("image_offset_x0", ci), ("image_offset_y0", ci),
            ("subsampling_dx", ci), ("subsampling_dy", ci),
            ("decod_format", ci), ("cod_format", ci), ("jpwl_epc_on", ci),
            ("jpwl_hprot_MH", ci), ("jpwl_hprot_TPH_tileno", ci * 16),
            ("jpwl_hprot_TPH", ci * 16), ("jpwl_pprot_tileno", ci * 16),
            ("jpwl_pprot_packno", ci * 16), ("jpwl_pprot", ci * 16),
            ("jpwl_sens_size", ci), ("jpwl_sens_addr", ci),
            ("jpwl_sens_range", ci), ("jpwl_sens_MH", ci),
            ("jpwl_sens_TPH_tileno", ci * 16), ("jpwl_sens_TPH", ci * 16),
            ("cp_cinema", ci), ("max_comp_size", ci), ("cp_rsiz", ci),
            ("tp_on", c.c_char), ("tp_flag", c.c_char), ("tcp_mct", c.c_char),
            ("jpip_on", ci), ("mct_data", c.c_void_p), ("max_cs_size", ci),
            ("rsiz", c.c_uint16)]

    class CmptParm(c.Structure):
        _fields_ = [(n, u32) for n in ("dx", "dy", "w", "h", "x0", "y0",
                                       "prec", "bpp", "sgnd")]

    class Comp(c.Structure):
        _fields_ = [(n, u32) for n in ("dx", "dy", "w", "h", "x0", "y0",
                                       "prec", "bpp", "sgnd", "resno_decoded",
                                       "factor")] + \
            [("data", c.POINTER(i32)), ("alpha", c.c_uint16)]

    class Image(c.Structure):
        _fields_ = [("x0", u32), ("y0", u32), ("x1", u32), ("y1", u32),
                    ("numcomps", u32), ("color_space", c.c_int),
                    ("comps", c.POINTER(Comp)),
                    ("icc_profile_buf", c.c_void_p),
                    ("icc_profile_len", u32)]
    return Params, CmptParm, Image


def openjpeg_encode(planes, prec=8, sgnd=0, dx=None, dy=None, jp2=False,
                    offset=(0, 0), tile=None, layers=None, numres=None,
                    cblk=None, mode=0, irreversible=False, roi=None,
                    precincts=None, prog="LRCP", pocs=None, csty=0, mct=None,
                    tile_parts=None, extra=None) -> bytes:
    """A codestream (or, with jp2, a JP2 file) from the system libopenjp2's
    encoder (2.5.0 here; ctypes over openjpeg.h's structures): ``planes``
    are the components' sample arrays; ``mode`` the code-block style bits
    (1 BYPASS, 2 RESET, 4 TERMALL, 8 VSC, 16 PTERM, 32 SEGSYM); ``layers``
    rates, one a layer (none: one lossless layer); ``pocs`` (resno0,
    compno0, layno1, resno1, compno1, order) tuples; ``csty`` 2 SOP, 4 EPH;
    ``tile_parts`` 'R', 'L' or 'C'; ``extra`` options such as 'PLT=YES' or
    'TLM=YES'.  Raises when the library refuses the parameters."""
    import ctypes as c

    params_t, cmpt_t, image_t = _opj_types()
    lib = c.CDLL(_OPJ_LIB)
    lib.opj_image_create.restype = c.POINTER(image_t)
    lib.opj_image_create.argtypes = [c.c_uint32, c.POINTER(cmpt_t), c.c_int]
    lib.opj_create_compress.restype = c.c_void_p
    lib.opj_setup_encoder.argtypes = [c.c_void_p, c.POINTER(params_t),
                                      c.POINTER(image_t)]
    lib.opj_encoder_set_extra_options.argtypes = [c.c_void_p,
                                                  c.POINTER(c.c_char_p)]
    lib.opj_stream_create_default_file_stream.restype = c.c_void_p
    lib.opj_stream_create_default_file_stream.argtypes = [c.c_char_p, c.c_int]
    lib.opj_start_compress.argtypes = [c.c_void_p, c.POINTER(image_t),
                                       c.c_void_p]
    for fn in ("opj_encode", "opj_end_compress"):
        getattr(lib, fn).argtypes = [c.c_void_p, c.c_void_p]
    lib.opj_stream_destroy.argtypes = [c.c_void_p]
    lib.opj_destroy_codec.argtypes = [c.c_void_p]
    lib.opj_image_destroy.argtypes = [c.POINTER(image_t)]
    n = len(planes)
    parms = (cmpt_t * n)()
    each = lambda v, i: v[i] if isinstance(v, (list, tuple)) else v  # noqa
    for i, pl in enumerate(planes):
        parms[i].dx, parms[i].dy = (dx or [1] * n)[i], (dy or [1] * n)[i]
        parms[i].h, parms[i].w = pl.shape
        parms[i].x0, parms[i].y0 = offset
        parms[i].prec = parms[i].bpp = each(prec, i)
        parms[i].sgnd = each(sgnd, i)
    img = lib.opj_image_create(n, parms, 0)
    im = img.contents
    im.x0, im.y0 = offset
    im.x1 = offset[0] + (planes[0].shape[1] - 1) * (dx or [1])[0] + 1
    im.y1 = offset[1] + (planes[0].shape[0] - 1) * (dy or [1])[0] + 1
    for i, pl in enumerate(planes):
        a = np.ascontiguousarray(pl, np.int32).ravel()
        c.memmove(im.comps[i].data, a.ctypes.data, a.nbytes)
    p = params_t()
    lib.opj_set_default_encoder_parameters(c.byref(p))
    if tile:
        p.tile_size_on, (p.cp_tdx, p.cp_tdy) = 1, tile
    p.image_offset_x0, p.image_offset_y0 = offset
    p.cp_disto_alloc = 1
    p.tcp_numlayers = len(layers) if layers else 1
    for i, r in enumerate(layers or [0]):
        p.tcp_rates[i] = r
    side = int(min([*planes[0].shape, *(tile or ())]))
    p.numresolution = numres or max(1, min(6, side.bit_length()))
    if cblk:
        p.cblockw_init, p.cblockh_init = cblk
    p.mode, p.irreversible = mode, int(irreversible)
    if roi:
        p.roi_compno, p.roi_shift = roi
    if precincts:
        p.csty |= 1
        p.res_spec = len(precincts)
        for i, (pw, ph) in enumerate(precincts):
            p.prcw_init[i], p.prch_init[i] = pw, ph
    p.csty |= csty
    p.prog_order = _OPJ_PROG[prog]
    for i, (r0, c0, l1, r1, c1, order) in enumerate(pocs or ()):
        q = p.POC[i]
        q.tile, q.resno0, q.compno0, q.layno1, q.resno1, q.compno1 = \
            1, r0, c0, l1, r1, c1
        q.prg1, q.progorder = _OPJ_PROG[order], order.encode()
    p.numpocs = len(pocs or ())
    if mct is not None:
        p.tcp_mct = bytes([mct])
    if tile_parts:
        p.tp_on, p.tp_flag = b"\x01", tile_parts.encode()
    codec = lib.opj_create_compress(2 if jp2 else 0)
    ok = lib.opj_setup_encoder(codec, c.byref(p), img)
    if ok and extra:
        opts = (c.c_char_p * (len(extra) + 1))(*[e.encode() for e in extra],
                                               None)
        ok = lib.opj_encoder_set_extra_options(codec, opts)
    data = None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out")
        if ok:
            st = lib.opj_stream_create_default_file_stream(path.encode(), 0)
            ok = lib.opj_start_compress(codec, img, st) and \
                lib.opj_encode(codec, st) and lib.opj_end_compress(codec, st)
            lib.opj_stream_destroy(st)
            if ok:
                with open(path, "rb") as f:
                    data = f.read()
    lib.opj_destroy_codec(codec)
    lib.opj_image_destroy(img)
    if data is None:
        raise RuntimeError("libopenjp2 refused the encoding parameters")
    return data


def jp2_box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def jp2_file(codestream: bytes, numcomps: int, h: int, w: int, colr=16,
             extra=b"", bpc=7, before=b"", after=b"",
             ftyp=b"jp2 \0\0\0\0jp2 ") -> bytes:
    """A JP2 file around a codestream: the signature, ftyp, jp2h (ihdr, an
    enumerated colr unless colr is None, then ``extra`` boxes), boxes
    ``before`` and ``after`` jp2h, then jp2c."""
    ihdr = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, numcomps, bpc, 7,
                                        0, 0))
    col = b"" if colr is None else jp2_box(b"colr", b"\x01\0\0"
                                           + struct.pack(">I", colr))
    return (jp2_box(b"jP  ", b"\r\n\x87\n") + jp2_box(b"ftyp", ftyp) + before
            + jp2_box(b"jp2h", ihdr + col + extra) + after
            + jp2_box(b"jp2c", codestream))


def jp2_pclr(entries: np.ndarray, sizes) -> bytes:
    ne, npc = entries.shape
    body = struct.pack(">HB", ne, npc) + bytes((s - 1) & 0x7F for s in sizes)
    for row in entries:
        for i, v in enumerate(row):
            body += int(v).to_bytes(min((sizes[i] + 7) >> 3, 4), "big")
    return jp2_box(b"pclr", body)


def jp2_cmap(items) -> bytes:
    return jp2_box(b"cmap", b"".join(struct.pack(">HBB", *it) for it in items))


def jp2_cdef(items) -> bytes:
    return jp2_box(b"cdef", struct.pack(">H", len(items)) + b"".join(
        struct.pack(">HHH", *it) for it in items))


def packed_headers(codestream: bytes, where: str, chunk: int = 65000) -> bytes:
    """A codestream written with SOP and EPH markers (``csty=6``) with its
    packet headers (each up to and with its EPH) moved out of the tile
    data: into PPT markers of each tile-part (``where='ppt'``; Zppt counts
    on over a tile's parts) or PPM markers of the main header (``'ppm'``;
    an Nppm field never split between two markers, as OpenJPEG requires),
    ``chunk`` bytes a marker at most.  The SOP markers stay before each
    packet's body."""
    def markers(code, segments, z=0):
        out = b""
        for seg in segments:
            out += struct.pack(">HHB", code, 3 + len(seg), z) + seg
            z += 1
        return out, z

    def split(data):
        return [data[i:i + chunk] for i in range(0, max(len(data), 1), chunk)]
    first = codestream.index(b"\xff\x90")
    main, pos, parts, zppt, ppm = codestream[:first], first, [], {}, [b""]
    while codestream[pos:pos + 2] == b"\xff\x90":
        tile, psot = struct.unpack(">HI", codestream[pos + 4:pos + 10])
        part = codestream[pos:pos + psot]
        sod = part.index(b"\xff\x93")
        data, heads, body = part[sod + 2:], b"", b""
        sops = [i for i in range(len(data) - 1)
                if data[i] == 0xFF and data[i + 1] == 0x91]
        for k, start in enumerate(sops):
            end = sops[k + 1] if k + 1 < len(sops) else len(data)
            eph = data.index(b"\xff\x92", start + 6) + 2
            heads += data[start + 6:eph]
            body += data[start:start + 6] + data[eph:end]
        header = part[12:sod]
        if where == "ppt":
            ppt, zppt[tile] = markers(0xFF61, split(heads), zppt.get(tile, 0))
            header += ppt
        else:
            record = struct.pack(">I", len(heads)) + heads
            if chunk - len(ppm[-1]) < 4:
                ppm.append(b"")
            room = chunk - len(ppm[-1])
            ppm[-1] += record[:room]
            ppm += split(record[room:]) if len(record) > room else []
        new = header + b"\xff\x93" + body
        parts.append(part[:6] + struct.pack(">I", 12 + len(new)) + part[10:12]
                     + new)
        pos += psot
    if where == "ppm":
        main += markers(0xFF60, ppm)[0]
    return main + b"".join(parts) + codestream[pos:]


def pil_jpeg2000(img: np.ndarray, **kw) -> bytes:
    """PIL's JPEG 2000 file of ``img`` (its bundled OpenJPEG 2.5.4; a
    uint16 array is PIL's I;16) with PIL's save options ``kw``."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _timing_factor(name: str) -> float:
    """timing_area_f<f>.png -> f"""
    return float(name[len("timing_area_f"):-len(".png")])


def generate_pyramid(folder: str = FOLDER) -> dict:
    """The fixtures of ENCODED_J2K_RATE and RESIZED, from cv2; returns
    TIMING_CV2's SHA-256s."""
    import hashlib

    import cv2

    from gsplat_tpu_torch.utils.image_io import read_png, write_png

    p = lambda name: os.path.join(folder, name)       # noqa: E731
    write_png(p("enc_j2k_src2.png"), fixture_image(62, 82, seed=22))
    x1000 = cv2.IMWRITE_JPEG2000_COMPRESSION_X1000
    for name, (src, x) in ENCODED_J2K_RATE.items():
        bgr = np.ascontiguousarray(read_png(p(src))[..., ::-1])
        assert cv2.imwrite(p(name), bgr, [x1000, x])
    src = read_png(p(RESIZE_SRC))
    for name, f in RESIZED.items():
        write_png(p(name), cv2.resize(src, None, fx=1 / f, fy=1 / f,
                                      interpolation=cv2.INTER_AREA))
    view = np.ascontiguousarray(cv2.imread(p(TIMING))[..., ::-1])
    shas = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "default.jp2")
        assert cv2.imwrite(path, np.ascontiguousarray(view[..., ::-1]))
        with open(path, "rb") as f:
            shas["timing_default.jp2"] = hashlib.sha256(f.read()).hexdigest()
    for name in list(TIMING_CV2)[1:]:
        f = _timing_factor(name)
        small = cv2.resize(view, None, fx=1 / f, fy=1 / f,
                           interpolation=cv2.INTER_AREA)
        shas[name] = hashlib.sha256(small.tobytes()).hexdigest()
    return shas


def generate_jpeg2000(folder: str = FOLDER) -> dict:
    """The JPEG 2000 fixtures of J2K_CASES, J2K_REFUSED, ENCODED_J2K and
    TIMING_J2K; returns TIMING_J2K's SHA-256s."""
    import hashlib

    import cv2

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(15)
    img = fixture_image(seed=6)
    h, w = img.shape[:2]
    pl = [img[..., k] for k in range(3)]
    p = lambda name: os.path.join(folder, name)       # noqa: E731

    def save(name, data):
        with open(p(name), "wb") as f:
            f.write(data)
    big = fixture_image(40, 48, seed=7)
    bgr = np.ascontiguousarray(big[..., ::-1])
    x1000 = cv2.IMWRITE_JPEG2000_COMPRESSION_X1000
    assert cv2.imwrite(p("j2k_cv2_lossless.jp2"), bgr, [x1000, 1000])
    assert cv2.imwrite(p("j2k_cv2_default.jp2"), bgr)
    assert cv2.imwrite(p("j2k_cv2_x50.jp2"), bgr, [x1000, 50])
    save("j2k_pil_rgb.jp2", pil_jpeg2000(img))
    save("j2k_pil_97_layers.jp2", pil_jpeg2000(
        img, irreversible=True, quality_layers=[40, 20, 10],
        progression="RPCL", tile_size=(16, 16), precinct_size=(16, 16),
        codeblock_size=(8, 8), plt=True))
    save("j2k_pil_raw.j2k", pil_jpeg2000(img, no_jp2=True, progression="CPRL",
                                         num_resolutions=3, mct=1))
    save("j2k_pil_gray.jp2", pil_jpeg2000(img[..., 1]))
    save("j2k_pil_rgba.jp2", pil_jpeg2000(np.dstack([img, img[..., :1]])))
    save("j2k_pil_gray16.jp2", pil_jpeg2000(
        rng.integers(0, 65536, (h, w)).astype(np.uint16)))
    save("j2k_pil_la.jp2", pil_jpeg2000(img[..., :2].copy()))
    for name, kw in (
            ("j2k_bypass.j2k", dict(mode=1, layers=[20, 8])),
            ("j2k_reset_termall.j2k", dict(mode=2 | 4, layers=[20, 8])),
            ("j2k_vsc_segsym.j2k", dict(mode=8 | 32)),
            ("j2k_pterm.j2k", dict(mode=16, layers=[12])),
            ("j2k_all_styles_97.j2k", dict(mode=63, irreversible=True,
                                           layers=[20, 8])),
            ("j2k_roi.j2k", dict(roi=(0, 5), layers=[10])),
            ("j2k_poc.j2k", dict(layers=[20, 10], numres=3,
                                 pocs=[(0, 0, 2, 2, 3, "RPCL"),
                                       (0, 0, 2, 3, 3, "LRCP")])),
            ("j2k_tile_parts.j2k", dict(tile=(16, 16), tile_parts="R",
                                        layers=[20, 8])),
            ("j2k_tlm.j2k", dict(tile=(16, 16), extra=["TLM=YES"])),
            ("j2k_sop_eph.j2k", dict(csty=2 | 4, layers=[20, 8],
                                     prog="PCRL")),
            ("j2k_cblk_4x64.j2k", dict(cblk=(4, 64), mode=8))):
        save(name, openjpeg_encode(pl, **kw))
    sop_eph = openjpeg_encode(pl, csty=6, tile=(16, 16), layers=[20, 8])
    save("j2k_ppt.j2k", packed_headers(sop_eph, "ppt", 100))
    save("j2k_ppm.j2k", packed_headers(sop_eph, "ppm", 300))
    save("j2k_prec12.j2k", openjpeg_encode([v.astype(int) * 16 + 7
                                            for v in pl], prec=12))
    idx = rng.integers(0, 20, (h, w))
    cs = openjpeg_encode([idx])
    save("j2k_pclr.jp2", jp2_file(cs, 1, h, w, extra=jp2_pclr(
        rng.integers(0, 256, (20, 3)), [8, 8, 8]) + jp2_cmap(
        [(0, 1, k) for k in range(3)])))
    cs4 = openjpeg_encode(pl + [idx * 12])
    save("j2k_cdef_alpha_first.jp2", jp2_file(cs4, 4, h, w, extra=jp2_cdef(
        [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)])))
    cs3 = openjpeg_encode(pl)
    save("j2k_sycc.jp2", jp2_file(cs3, 3, h, w, colr=18))
    save("j2k_icc.jp2", jp2_file(cs3, 3, h, w, colr=None, extra=jp2_box(
        b"colr", b"\x02\0\0" + bytes(rng.integers(0, 256, 40, np.uint8)))))
    save("j2k_gray_colr_rgb.jp2", jp2_file(cs3, 3, h, w, colr=17))
    # what cv2 refuses
    save("j2k_raw_gray.j2k", openjpeg_encode(pl[:1]))
    save("j2k_signed.j2k", openjpeg_encode([v.astype(int) - 128 for v in pl],
                                           sgnd=1))
    save("j2k_offset.j2k", openjpeg_encode(pl, offset=(3, 5)))
    whole = jp2_file(cs3, 3, h, w)
    save("j2k_cut_60.jp2", whole[:len(whole) * 6 // 10])
    save("j2k_5comp.j2k", openjpeg_encode(pl + pl[:2]))
    save("j2k_prec4.j2k", openjpeg_encode([v >> 4 for v in pl], prec=4))
    save("j2k_subsampled.j2k", openjpeg_encode(
        [pl[0], pl[1][::2, ::2], pl[2][::2, ::2]], dx=[1, 2, 2], dy=[1, 2, 2]))
    save("j2k_cmyk.jp2", jp2_file(openjpeg_encode(pl + pl[:1]), 4, h, w,
                                  colr=12))
    save("j2k_rgb_2comp.jp2", jp2_file(openjpeg_encode(pl[:2]), 2, h, w))
    # write_jpeg2000 against cv2's bytes
    from gsplat_tpu_torch.utils.image_io import write_png

    src = fixture_image(37, 45, seed=10)
    write_png(p(ENCODED_J2K_SRC), src)
    assert cv2.imwrite(p(ENCODED_J2K[0]), np.ascontiguousarray(src[..., ::-1]),
                       [x1000, 1000])
    # the full-size timing views
    view = cv2.imread(p(TIMING))
    names = list(TIMING_J2K)
    assert cv2.imwrite(p(names[0]), view, [x1000, 50])
    rgb = view[..., ::-1]
    save(names[1], openjpeg_encode(
        [rgb[..., k] for k in range(3)], jp2=True, irreversible=True,
        layers=[160, 80, 40], prog="RPCL", tile=(512, 512),
        precincts=[(128, 128)] * 6, csty=2 | 4, extra=["PLT=YES"]))
    shas = {}
    for name in names:
        dec = np.ascontiguousarray(cv2.imread(p(name))[..., ::-1])
        shas[name] = hashlib.sha256(dec.tobytes()).hexdigest()
    return shas

def generate_avif(folder: str = FOLDER, mid_scene: str | None = None
                  ) -> dict:
    """The AVIF fixtures of AVIF_CASES, AVIF_REFUSED, AVIF_UNPORTED and
    TIMING_AVIF (and, given the folder of make_synth_scene --preset mid,
    AVIF_MID's, AVIF_MID_SCREEN's and AVIF_MID_GRAIN's views); returns
    TIMING_AVIF's SHA-256s."""
    import hashlib

    import cv2

    import torch_avif_oracles as oracle

    os.makedirs(folder, exist_ok=True)
    p = lambda name: os.path.join(folder, name)       # noqa: E731

    def save(name, data):
        with open(p(name), "wb") as f:
            f.write(data)
    rng = np.random.default_rng(17)
    bgr = np.ascontiguousarray(fixture_image(seed=11)[..., ::-1])
    data = oracle.cv2_avif(bgr)
    save("avif_cv2_default.avif", data)
    save("avif_cv2_q90.avif", oracle.cv2_avif(bgr, 90))
    save("avif_cv2_lossless.avif", oracle.cv2_avif(bgr, 100))
    deep = oracle.deepen(bgr, rng)
    save("avif_cv2_d10.avif", oracle.cv2_avif(deep, depth=10))
    save("avif_cv2_d12.avif", oracle.cv2_avif(deep, depth=12))
    for h, w in ((1, 1), (3, 5), (17, 33), (130, 67)):
        save(f"avif_cv2_{h}x{w}.avif",
             oracle.cv2_avif(oracle.avif_image("photo", h, w, rng)))
    big = oracle.avif_image("photo", 72, 104, rng)
    save("avif_pil_444.avif", oracle.pillow_avif(
        big, **oracle.PILLOW_OPTIONS["444"]))
    save("avif_pil_sb128.avif", oracle.pillow_avif(
        big, **oracle.PILLOW_OPTIONS["sb128"]))
    save("avif_pil_cdef_qm.avif", oracle.pillow_avif(
        big, quality=50, advanced={"enable-cdef": "1", "enable-qm": "1"}))
    zzzz = struct.pack(">I4s", 8, b"zzzz")
    save("avif_unknown_property.avif",
         oracle.insert_property(data, zzzz, False))
    # what cv2 refuses
    i = data.find(b"ispe")
    save("avif_no_ispe.avif", data[:i] + b"xspe" + data[i + 4:])
    past = bytearray(data)
    struct.pack_into(">I", past, oracle.iloc_length_at(data), 100000)
    save("avif_iloc_past_end.avif", bytes(past))
    save("avif_essential_unknown.avif",
         oracle.insert_property(data, zzzz, True))
    save("avif_cut.avif", data[:len(data) - 20])
    save("avif_pil_422.avif", oracle.pillow_avif(big, subsampling="4:2:2"))
    save("avif_pil_400.avif", oracle.pillow_avif(big, subsampling="4:0:0"))
    save("avif_pil_alpha.avif", oracle.pillow_avif(
        np.dstack([big, big[..., :1]])))
    screen = {"tune-content": "screen"}
    save("avif_pil_palette.avif", oracle.pillow_avif(
        oracle.screen_image("blocks", 96, 128, np.random.default_rng(3)),
        advanced=screen))
    save("avif_pil_intrabc.avif", oracle.pillow_avif(
        oracle.screen_image("text", 200, 300, np.random.default_rng(4)),
        advanced=screen))
    save("avif_pil_grain.avif", oracle.pillow_avif(
        big, advanced={"film-grain-test": "1"}))
    save("avif_pil_denoise.avif", oracle.pillow_avif(
        big, advanced={"denoise-noise-level": AVIF_DENOISE}))
    save("avif_pil_grain_alpha.avif", oracle.pillow_avif(
        np.dstack([big, big[..., 1:2]]), advanced={"film-grain-test": "9"}))
    obu, props = oracle.item_parts(data)
    g = oracle.grain_dict(oracle.port_grain_params(oracle.item_parts(
        oracle.pillow_avif(big, advanced={"film-grain-test": "1"}))[0])[1])
    g["y"] = [(16 * i, 5 + i) for i in range(15)]
    save("avif_grain_15_points.avif", oracle.build_avif(
        oracle.with_grain(obu, g), props))
    tiles = [oracle.tile_item(oracle.cv2_avif(t)) for t in
             oracle.split_tiles(big, 2, 2, 64, 64)]
    save("avif_grid.avif", oracle.grid_avif(tiles, 2, 2, 104, 72))
    save("avif_grid_3_tiles.avif", oracle.grid_avif(tiles, 2, 2, 104, 72,
                                                    dimg=[0, 1, 2]))
    wide = oracle.avif_image("photo", 64, 150, rng)
    tiles = [oracle.tile_item(oracle.pillow_avif(t, subsampling="4:4:4"))
             for t in oracle.split_tiles(wide, 1, 3, 64, 64)]
    alpha = []
    for t in oracle.split_tiles(wide, 1, 2, 80, 64):
        _, _, aobu, aprops = oracle.alpha_parts(oracle.pillow_avif(
            np.dstack([t, t[..., :1]]), advanced={"film-grain-test": "3"}))
        alpha.append((aobu, [(b, e) for b, e in aprops
                             if b[4:8] != b"auxC"]))
    save("avif_grid_alpha.avif", oracle.grid_avif(tiles, 1, 3, 150, 64,
                                                  alpha=(alpha, 1, 2)))
    # what cv2 reads and the port does not yet
    save("avif_irot.avif", oracle.insert_property(
        data, struct.pack(">I4sB", 9, b"irot", 1), True))
    # the full-size views
    view = cv2.imread(p(TIMING))
    names = list(TIMING_AVIF)
    save(names[0], oracle.cv2_avif(view))
    save(names[1], oracle.cv2_avif(view.astype(np.uint16) * 257, depth=10))
    save(names[2], oracle.cv2_avif(view.astype(np.uint16) * 257, depth=12))
    save(names[3], oracle.cv2_avif(np.ascontiguousarray(
        view[316:524, 488:808]), 100))
    save(names[4], oracle.pillow_avif(view,
                                      **oracle.PILLOW_OPTIONS["tiles_4x2"]))
    save(names[5], oracle.pillow_avif(view, **oracle.PILLOW_OPTIONS["444"]))
    save(names[6], oracle.pillow_avif(screen_view(view), advanced=screen))
    save(names[7], oracle.pillow_avif(view, subsampling="4:2:2"))
    save(names[8], oracle.pillow_avif(view, subsampling="4:0:0"))
    save(names[9], oracle.pillow_avif(np.dstack([view, screen_alpha(
        *view.shape[:2])])))
    save(names[10], oracle.pillow_avif(view, advanced={
        "film-grain-test": "1"}))
    save(names[11], oracle.pillow_avif(view, advanced={
        "denoise-noise-level": AVIF_DENOISE}))
    tiles = [oracle.tile_item(oracle.pillow_avif(t, subsampling="4:4:4"))
             for t in oracle.split_tiles(view, 2, 3, 433, 420)]
    save(names[12], oracle.grid_avif(tiles, 2, 3, view.shape[1],
                                     view.shape[0]))
    shas = {}
    for name in names:
        dec = np.ascontiguousarray(cv2.imread(p(name))[..., ::-1])
        shas[name] = hashlib.sha256(dec.tobytes()).hexdigest()
    if mid_scene is not None:
        src = os.path.join(mid_scene, "images_4")
        for sub in (AVIF_MID, AVIF_MID_SCREEN, AVIF_MID_GRAIN):
            os.makedirs(p(sub), exist_ok=True)
        for k, name in enumerate(sorted(os.listdir(src))):
            bgr = cv2.imread(os.path.join(src, name))
            save(os.path.join(AVIF_MID, name[:-4] + ".avif"),
                 oracle.cv2_avif(bgr))
            rgba = np.dstack([bgr, screen_alpha(*bgr.shape[:2])])
            save(os.path.join(AVIF_MID_SCREEN, name[:-4] + ".avif"),
                 oracle.pillow_avif(rgba, **AVIF_SCREEN_OPTS))
            grain = {"film-grain-test": str(k + 1)} if k < 16 else {
                "denoise-noise-level": AVIF_DENOISE}
            save(os.path.join(AVIF_MID_GRAIN, name[:-4] + ".avif"),
                 oracle.pillow_avif(bgr, advanced=grain))
    return shas


_JPEGW = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>
__attribute__((weak)) void jpeg_enable_lossless(j_compress_ptr, int, int);
__attribute__((weak)) JDIMENSION jpeg12_write_scanlines(j_compress_ptr,
                                                         short **, JDIMENSION);
/* jpegw OUT RAW W H C [-q Q] [-arith] [-prog] [-restart N] [-space S]
   [-lossless PSV PT] [-prec 12] [-dac L U K]: RAW holds H*W*C samples
   (16-bit with -prec 12). */
int main(int argc, char **argv) {
  const char *out = argv[1], *raw = argv[2];
  int W = atoi(argv[3]), H = atoi(argv[4]), C = atoi(argv[5]);
  int q = 90, arith = 0, prog = 0, rst = 0, psv = 0, pt = 0, prec = 8;
  int dac = 0, L = 0, U = 1, K = 5;
  const char *space = NULL;
  for (int i = 6; i < argc; i++) {
    if (!strcmp(argv[i], "-q")) q = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-arith")) arith = 1;
    else if (!strcmp(argv[i], "-prog")) prog = 1;
    else if (!strcmp(argv[i], "-restart")) rst = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-lossless")) {
      psv = atoi(argv[++i]); pt = atoi(argv[++i]); }
    else if (!strcmp(argv[i], "-prec")) prec = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-space")) space = argv[++i];
    else if (!strcmp(argv[i], "-dac")) {
      dac = 1; L = atoi(argv[++i]); U = atoi(argv[++i]); K = atoi(argv[++i]); }
  }
  size_t bps = prec > 8 ? 2 : 1, n = (size_t)W * H * C * bps;
  unsigned char *buf = malloc(n);
  FILE *f = fopen(raw, "rb");
  if (!f || fread(buf, 1, n, f) != n) return 2;
  fclose(f);
  struct jpeg_compress_struct ci;
  struct jpeg_error_mgr je;
  ci.err = jpeg_std_error(&je);
  jpeg_create_compress(&ci);
  FILE *o = fopen(out, "wb");
  jpeg_stdio_dest(&ci, o);
  ci.image_width = W; ci.image_height = H; ci.input_components = C;
  ci.in_color_space = C == 1 ? JCS_GRAYSCALE : C == 3 ? JCS_RGB :
                      C == 4 ? JCS_CMYK : JCS_UNKNOWN;
  if (prec != 8) ci.data_precision = prec;
  jpeg_set_defaults(&ci);
  if (space) jpeg_set_colorspace(&ci, !strcmp(space, "ycck") ? JCS_YCCK :
                                       !strcmp(space, "rgb") ? JCS_RGB :
                                       JCS_CMYK);
  jpeg_set_quality(&ci, q, TRUE);
  if (arith) ci.arith_code = TRUE;
  if (dac) for (int t = 0; t < 16; t++) {
    ci.arith_dc_L[t] = L; ci.arith_dc_U[t] = U; ci.arith_ac_K[t] = K; }
  if (prog) jpeg_simple_progression(&ci);
  if (rst) ci.restart_interval = rst;
  if (psv) jpeg_enable_lossless(&ci, psv, pt);
  jpeg_start_compress(&ci, TRUE);
  while (ci.next_scanline < (JDIMENSION)H) {
    unsigned char *row = buf + (size_t)ci.next_scanline * W * C * bps;
    if (prec > 8) { short *r = (short *)row; jpeg12_write_scanlines(&ci, &r, 1); }
    else jpeg_write_scanlines(&ci, &row, 1);
  }
  jpeg_finish_compress(&ci);
  fclose(o);
  return 0;
}
"""


_WEBPW = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <webp/encode.h>
/* webpw OUT RAW W H C [FIELD VALUE]...: RAW holds H*W*C bytes (C = 3 or
   4); each FIELD a member of WebPConfig. */
int main(int argc, char **argv) {
  const char *out = argv[1], *raw = argv[2];
  int W = atoi(argv[3]), H = atoi(argv[4]), C = atoi(argv[5]);
  size_t n = (size_t)W * H * C;
  unsigned char *buf = malloc(n);
  FILE *f = fopen(raw, "rb");
  if (!f || fread(buf, 1, n, f) != n) return 2;
  fclose(f);
  WebPConfig cfg;
  if (!WebPConfigInit(&cfg)) return 3;
  for (int i = 6; i + 1 < argc; i += 2) {
    const char *k = argv[i];
    double v = atof(argv[i + 1]);
#define F(name) else if (!strcmp(k, #name)) cfg.name = v;
    if (0) {}
    F(lossless) F(quality) F(method) F(segments) F(sns_strength)
    F(filter_strength) F(filter_sharpness) F(filter_type) F(autofilter)
    F(alpha_compression) F(alpha_filtering) F(alpha_quality) F(pass)
    F(preprocessing) F(partitions) F(near_lossless) F(exact) F(use_sharp_yuv)
    else return 4;
  }
  if (!WebPValidateConfig(&cfg)) return 5;
  WebPPicture pic;
  if (!WebPPictureInit(&pic)) return 3;
  pic.width = W; pic.height = H; pic.use_argb = 1;
  if (!(C == 4 ? WebPPictureImportRGBA(&pic, buf, W * 4)
               : WebPPictureImportRGB(&pic, buf, W * 3))) return 6;
  WebPMemoryWriter wr;
  WebPMemoryWriterInit(&wr);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &wr;
  if (!WebPEncode(&cfg, &pic)) return 7;
  FILE *o = fopen(out, "wb");
  fwrite(wr.mem, 1, wr.size, o);
  fclose(o);
  return 0;
}
"""


def fixture_image(h: int = H, w: int = W, seed: int = 0) -> np.ndarray:
    """A smooth (H, W, 3) uint8 image with light noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 7 + y / 11),
                    128 + 90 * np.cos(x / 5 - y / 9),
                    128 + 80 * np.sin((x + y) / 13)], axis=2)
    img += rng.normal(0, 6, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


# ------------------------------------------------------------ JPEG writers


def _jpeg_tools(tmp: str):
    """The C writer built twice: over the system libjpeg-turbo (2.1) and
    over Pillow's bundled libjpeg-turbo 3 (lossless, 12-bit)."""
    import glob

    import PIL

    src = os.path.join(tmp, "jpegw.c")
    with open(src, "w") as f:
        f.write(_JPEGW)
    sys_tool, pil_tool = os.path.join(tmp, "jpegw_sys"), \
        os.path.join(tmp, "jpegw_pil")
    subprocess.run(["gcc", "-O1", "-o", sys_tool, src, "-ljpeg"], check=True)
    libs = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    lib = sorted(glob.glob(os.path.join(libs, "libjpeg-*.so*")))[0]
    subprocess.run(["gcc", "-O1", "-o", pil_tool, src, lib,
                    f"-Wl,-rpath,{os.path.dirname(lib)}"], check=True)

    def write(tool, path, arr, *opts):
        arr = np.ascontiguousarray(arr)
        raw = os.path.join(tmp, "in.raw")
        arr.tofile(raw)
        h, w = arr.shape[:2]
        c = arr.shape[2] if arr.ndim == 3 else 1
        subprocess.run([tool, path, raw, str(w), str(h), str(c), *opts],
                       check=True)
    return (lambda *a: write(sys_tool, *a)), (lambda *a: write(pil_tool, *a))


def _scan_data(data: bytes):
    """(start, end) of each scan's entropy-coded data."""
    out, i = [], 2
    while i + 4 <= len(data):
        if data[i] != 0xFF or data[i + 1] in (0x00, 0xFF, 0xD8, 0xD9) or \
                0xD0 <= data[i + 1] <= 0xD7:
            i += 1
            continue
        length = (data[i + 2] << 8) | data[i + 3]
        if data[i + 1] != 0xDA:
            i += 2 + length
            continue
        j = i + 2 + length
        k = j
        while k + 1 < len(data) and not (
                data[k] == 0xFF and data[k + 1] not in (0x00, 0xFF)
                and not 0xD0 <= data[k + 1] <= 0xD7):
            k += 1
        out.append((j, k))
        i = k
    return out


def _cut(data: bytes, fraction: float) -> bytes:
    """The file cut at the first byte past ``fraction`` of it that lies in
    a scan's data (a cut inside a marker segment makes libjpeg fail)."""
    at = int(len(data) * fraction)
    for start, end in _scan_data(data):
        if end > at:
            return data[:max(at, start + 1)]
    raise ValueError("no scan data past the cut")


# ------------------------------------------------------------ WebP writers


def _webp_tool(tmp: str):
    """A C writer over the system libwebp's encoder (``encode.h``,
    ``-lwebp``): ``write(path, (H, W, 3|4) uint8, field, value, ...)`` with
    any WebPConfig fields (lossy options cv2 and PIL do not expose)."""
    src = os.path.join(tmp, "webpw.c")
    with open(src, "w") as f:
        f.write(_WEBPW)
    tool = os.path.join(tmp, "webpw")
    subprocess.run(["gcc", "-O1", "-o", tool, src, "-lwebp"], check=True,
                   capture_output=True)

    def write(path, arr, *opts):
        arr = np.ascontiguousarray(arr, np.uint8)
        raw = os.path.join(tmp, "in.raw")
        arr.tofile(raw)
        h, w = arr.shape[:2]
        subprocess.run([tool, str(path), raw, str(w), str(h),
                        str(arr.shape[2]), *map(str, opts)], check=True)
    return write


def webp_chunks(data: bytes) -> list:
    """A RIFF WebP's top-level chunks: [(tag, payload)]."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def webp_chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + \
        b"\x00" * (len(payload) & 1)


def webp_riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def webp_vp8x(flags: int, w: int, h: int) -> bytes:
    """A VP8X chunk (flags: 0x20 ICC, 0x10 alpha, 0x08 EXIF, 0x04 XMP,
    0x02 animation) for a w x h canvas."""
    return webp_chunk(b"VP8X", struct.pack("<I", flags)
                      + (w - 1).to_bytes(3, "little")
                      + (h - 1).to_bytes(3, "little"))


def webp_exif(orientation: int, endian: str = "<") -> bytes:
    """A TIFF-structured EXIF payload: IFD0 with tag 0x0112 only."""
    return ((b"II*\x00" if endian == "<" else b"MM\x00*")
            + struct.pack(endian + "IH", 8, 1)
            + struct.pack(endian + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + bytes(4))


def exif_edge_cases() -> dict:
    """EXIF payloads that OpenCV's ExifReader reads in its own way: name ->
    (payload, the orientation cv2 applies)."""
    six = webp_exif(6)
    two = six[:8] + struct.pack("<H", 2) + struct.pack(
        "<HHIHH", 0x0112, 3, 1, 3, 0) + struct.pack(
        "<HHIHH", 0x0112, 3, 1, 6, 0) + bytes(4)
    return {
        "intel": (six, 6),
        "motorola": (webp_exif(6, ">"), 6),
        "mark_43": (six.replace(b"II*\x00", b"II+\x00"), 1),
        "xx_read_big_endian": (b"XX" + webp_exif(6, ">")[2:], 6),
        "im_read_big_endian": (b"IM" + webp_exif(6, ">")[2:], 6),
        "entry_cut_after_value": (six[:20], 6),
        "entry_cut_in_value": (six[:19], 1),
        "value_9": (webp_exif(9), 1),
        "first_of_two": (two, 3),
    }


def webp_anmf(x: int, y: int, w: int, h: int, frame: bytes,
              flags: int = 0) -> bytes:
    """An ANMF chunk: a frame at (x, y) (even), w x h, 100 ms, holding
    ``frame`` (its ALPH / VP8 / VP8L chunks)."""
    return webp_chunk(b"ANMF", (x // 2).to_bytes(3, "little")
                      + (y // 2).to_bytes(3, "little")
                      + (w - 1).to_bytes(3, "little")
                      + (h - 1).to_bytes(3, "little")
                      + (100).to_bytes(3, "little") + bytes([flags]) + frame)


def webp_anim(canvas_w: int, canvas_h: int, frames: list,
              flags: int = 0x02) -> bytes:
    """An animated WebP: VP8X, ANIM (opaque white background, looping),
    then the ANMF chunks ``frames``."""
    return webp_riff(webp_vp8x(flags, canvas_w, canvas_h)
                     + webp_chunk(b"ANIM", struct.pack("<IH", 0xFFFFFFFF, 0))
                     + b"".join(frames))


def generate_webp(folder: str = FOLDER):
    """The WebP fixtures (of CASES, REFUSED and TIMING_WEBP); returns the
    SHA-256 of cv2's decode of the timing view."""
    import hashlib

    import cv2
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(13)
    img = fixture_image(seed=4)
    p = lambda name: os.path.join(folder, name)       # noqa: E731
    alpha = (np.arange(W)[None, :, None] * 6 + np.arange(H)[:, None, None]
             * 2).astype(np.uint8) + np.zeros((H, W, 1), np.uint8)
    rgba = np.concatenate([img, alpha], axis=2)

    def chunks_of(path):
        with open(path, "rb") as f:
            return webp_chunks(f.read())

    def save(name, data):
        with open(p(name), "wb") as f:
            f.write(data)

    with tempfile.TemporaryDirectory() as tmp:
        webpw = _webp_tool(tmp)
        t = lambda name: os.path.join(tmp, name)      # noqa: E731
        # lossless
        cv2.imwrite(p("webp_lossless.webp"), img[..., ::-1])
        Image.fromarray(img).save(p("webp_lossless_m6.webp"), lossless=True,
                                  method=6, quality=100)
        for ncol in (2, 4, 16, 256):
            pal = rng.integers(0, 256, (ncol, 3)).astype(np.uint8)
            webpw(p(f"webp_lossless_pal{ncol}.webp"),
                  pal[rng.integers(0, ncol, (H, W))], "lossless", 1,
                  "method", 4)
        webpw(p("webp_lossless_alpha.webp"), rgba, "lossless", 1, "exact", 1)
        webpw(p("webp_near_lossless.webp"), img, "lossless", 1,
              "near_lossless", 40)
        # lossy
        webpw(p("webp_lossy.webp"), img, "quality", 80)
        webpw(p("webp_lossy_parts4.webp"), img, "quality", 70, "partitions",
              2, "segments", 4, "sns_strength", 90)
        webpw(p("webp_lossy_simple_filter.webp"), img, "quality", 60,
              "filter_type", 0, "filter_strength", 70, "filter_sharpness", 4)
        webpw(p("webp_lossy_no_filter.webp"), img, "quality", 75,
              "filter_strength", 0, "segments", 1)
        webpw(p("webp_lossy_sharp_yuv.webp"), img, "quality", 85,
              "use_sharp_yuv", 1)
        webpw(p("webp_lossy_alpha_raw.webp"), rgba, "quality", 80,
              "alpha_compression", 0, "alpha_filtering", 1)
        webpw(p("webp_lossy_alpha_lossless.webp"), rgba, "quality", 80,
              "alpha_compression", 1, "alpha_filtering", 2)
        # a raw ALPH chunk under the gradient filter (bits 2-3 = 3)
        webpw(t("lossy.webp"), img, "quality", 80)
        vp8 = chunks_of(t("lossy.webp"))[0][1]
        save("webp_lossy_alpha_gradient.webp", webp_riff(
            webp_vp8x(0x10, W, H)
            + webp_chunk(b"ALPH", b"\x0c" + rgba[..., 3].tobytes())
            + webp_chunk(b"VP8 ", vp8)))
        # extended: EXIF orientation, ICC profile
        save("webp_exif_orientation6.webp", webp_riff(
            webp_vp8x(0x08, W, H) + webp_chunk(b"VP8 ", vp8)
            + webp_chunk(b"EXIF", webp_exif(6))))
        save("webp_iccp.webp", webp_riff(
            webp_vp8x(0x20, W, H) + webp_chunk(b"ICCP", bytes(range(61)))
            + webp_chunk(b"VP8 ", vp8)))
        # animated: a first frame smaller than the canvas, at an offset
        small = fixture_image(12, 16, seed=5)
        webpw(t("small.webp"), np.concatenate(
            [small, np.full((12, 16, 1), 128, np.uint8)], 2), "quality", 90)
        first = b"".join(webp_chunk(k, v) for k, v in
                         chunks_of(t("small.webp")) if k != b"VP8X")
        second = webp_chunk(b"VP8 ", vp8)
        save("webp_animated_offset.webp", webp_anim(
            W, H, [webp_anmf(10, 6, 16, 12, first),
                   webp_anmf(0, 0, W, H, second)], flags=0x12))
        # refused: a file cut short, a chunk running past the RIFF, a
        # corrupt ALPH (its lossless stream garbled), a frame outside the
        # canvas
        with open(p("webp_lossy.webp"), "rb") as f:
            data = f.read()
        save("webp_cut.webp", data[:len(data) * 2 // 3])
        save("webp_chunk_past_riff.webp", data[:4] + struct.pack(
            "<I", len(data) - 8 - 20) + data[8:])
        alph = chunks_of(p("webp_lossy_alpha_lossless.webp"))[1][1]
        junk = alph[:1] + bytes(rng.integers(0, 256, len(alph) - 1)
                                .astype(np.uint8))
        save("webp_bad_alph.webp", webp_riff(
            webp_vp8x(0x10, W, H) + webp_chunk(b"ALPH", junk)
            + webp_chunk(b"VP8 ", vp8)))
        save("webp_frame_outside_canvas.webp", webp_anim(
            W, H, [webp_anmf(30, 20, 16, 12, first)]))
    # the timing view: the arithmetic JPEG's decode at quality 90
    view = cv2.imread(p(TIMING))
    cv2.imwrite(p(TIMING_WEBP), view, [cv2.IMWRITE_WEBP_QUALITY, 90])
    dec = np.ascontiguousarray(cv2.imread(p(TIMING_WEBP))[..., ::-1])
    return hashlib.sha256(dec.tobytes()).hexdigest()


# ------------------------------------------------------------- PNG writer


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    h, w, _ = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = ((samples[..., 0][..., None] >> np.arange(depth - 1, -1, -1))
            & 1).astype(np.uint8).reshape(h, -1)
    return np.packbits(bits, axis=1)


def _png_filter(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row under a random filter type (0-4)."""
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for r in rows.astype(np.int64):
        t = int(rng.integers(0, 5))
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])[:len(r)]
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])[:len(r)]
        if t == 0:
            f = r
        elif t == 1:
            f = r - a
        elif t == 2:
            f = r - prior
        elif t == 3:
            f = r - ((a + prior) >> 1)
        else:
            p = a + prior - c
            pa, pb, pc = abs(p - a), abs(p - prior), abs(p - c)
            f = r - np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, prior, c))
        out.append(np.concatenate([[t], f & 0xFF]).astype(np.uint8))
        prior = r
    return b"".join(x.tobytes() for x in out)


def write_adam7_png(path, samples, depth, ctype, palette=None, seed=0):
    """An interlaced PNG of (H, W, C) samples, every row filtered."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = b"".join(_png_filter(_png_rows(samples[y0::dy, x0::dx], depth),
                               bpp, rng)
                   for x0, y0, dx, dy in _ADAM7
                   if samples[y0::dy, x0::dx].size)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 1))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


# ------------------------------------------------------------ TIFF writer


def _lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB first, early change, CLEAR at 4094), plain Python."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, nbits):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
    table, nbits, free = {}, 9, 258
    put(256, nbits)
    if data:
        cur = data[0]
        for c in data[1:]:
            if (cur, c) in table:
                cur = table[(cur, c)]
                continue
            put(cur, nbits)
            table[(cur, c)] = free
            free += 1
            cur = c
            if free == 4094:
                put(256, nbits)
                table, free, nbits = {}, 258, 9
            elif free > (1 << nbits) - 1:
                nbits += 1
        put(cur, nbits)
        free += 1
        if free > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    put(257, nbits)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def write_tiff_file(path, samples, bps=8, photometric=None, compression=1,
                    predictor=1, planar=1, tile=None, rows_per_strip=None,
                    endian="<", colormap=None, extra_samples=None):
    """A one-image TIFF: strips or tiles, chunky or planar, II or MM, no
    compression, LZW or Deflate, predictor 2 at 8 or 16 bits."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    if photometric is None:
        photometric = 1 if spp == 1 else 2
    planes = ([samples[..., k:k + 1] for k in range(spp)] if planar == 2
              else [samples])

    def encode(block):
        rows, cols, n = block.shape
        if predictor == 2:
            d = block.astype(np.int64)
            d[:, 1:] -= block[:, :-1].astype(np.int64)
            block = d & ((1 << bps) - 1)
        if bps == 16:
            raw = block.astype(endian + "u2").tobytes()
        elif bps == 8:
            raw = block.astype(np.uint8).tobytes()
        else:
            flat = block.reshape(rows, cols * n)
            bits = ((flat[..., None] >> np.arange(bps - 1, -1, -1)) & 1
                    ).astype(np.uint8).reshape(rows, -1)
            raw = np.packbits(bits, axis=1).tobytes()
        return {1: raw, 5: _lzw(raw), 8: zlib.compress(raw)}[compression]

    chunks = []
    for plane in planes:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    part = plane[ty:ty + th, tx:tx + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(blk))
        else:
            rps = rows_per_strip or h
            chunks += [encode(plane[y:y + rps]) for y in range(0, h, rps)]
    e = endian
    body = bytearray(b"II*\x00" if e == "<" else b"MM\x00*") + bytes(4)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + b"\x00" * (len(c) % 2)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if tile:
        tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]]),
                     324: (4, offsets), 325: (4, [len(c) for c in chunks])})
    else:
        tags.update({273: (4, offsets), 279: (4, [len(c) for c in chunks]),
                     278: (4, [rows_per_strip or h])})
    if colormap is not None:
        tags[320] = (3, list(np.asarray(colormap).T.reshape(-1)))
    if extra_samples is not None:
        tags[338] = (3, list(extra_samples))
    entries = []
    for t in sorted(tags):
        typ, vals = tags[t]
        raw = struct.pack(e + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(raw) > 4:
            entries.append(struct.pack(e + "HHII", t, typ, len(vals),
                                       len(body)))
            body += raw + b"\x00" * (len(raw) % 2)
        else:
            entries.append(struct.pack(e + "HHI", t, typ, len(vals))
                           + raw.ljust(4, b"\x00"))
    ifd = len(body)
    body += struct.pack(e + "H", len(entries)) + b"".join(entries) + bytes(4)
    body[4:8] = struct.pack(e + "I", ifd)
    with open(path, "wb") as f:
        f.write(bytes(body))


def write_jpeg_tiff(path, jpeg: bytes, h: int, w: int, subsampling):
    """A whole JFIF stream as the one strip of a YCbCr (photometric 6)
    JPEG-compressed TIFF, with its YCbCrSubsampling tag."""
    body = bytearray(b"II*\x00" + bytes(4)) + jpeg + b"\x00" * (len(jpeg) % 2)
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [8, 8, 8]), 259: (3, [7]),
            262: (3, [6]), 273: (4, [8]), 277: (3, [3]), 278: (3, [h]),
            279: (4, [len(jpeg)]), 284: (3, [1]), 530: (3, list(subsampling))}
    entries = []
    for t in sorted(tags):
        typ, vals = tags[t]
        raw = struct.pack("<" + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(raw) > 4:
            entries.append(struct.pack("<HHII", t, typ, len(vals), len(body)))
            body += raw
        else:
            entries.append(struct.pack("<HHI", t, typ, len(vals))
                           + raw.ljust(4, b"\x00"))
    ifd = len(body)
    body += struct.pack("<H", len(entries)) + b"".join(entries) + bytes(4)
    body[4:8] = struct.pack("<I", ifd)
    with open(path, "wb") as f:
        f.write(bytes(body))


# ------------------------------------------------------------- BMP writer


def _rle8(idx: np.ndarray) -> bytes:
    """Bottom-up RLE8: runs of 3 or more encoded, the rest absolute."""
    out = bytearray()
    for row in idx[::-1].tolist():
        x, w = 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 3:
                out += bytes([run, row[x]])
                x += run
                continue
            n = 3
            while x + n < w and n < 255 and not (
                    x + n + 2 < w and row[x + n] == row[x + n + 1]
                    == row[x + n + 2]):
                n += 1
            out += bytes([0, n]) + bytes(row[x:x + n]) + b"\x00" * (n % 2)
            x += n
        out += b"\x00\x00"
    out[-2:] = b"\x00\x01"
    return bytes(out)


def _rle4(idx: np.ndarray) -> bytes:
    """Bottom-up RLE4: two-color encoded runs and absolute runs."""
    out = bytearray()
    for row in idx[::-1].tolist():
        x, w = 0, len(row)
        while x < w:
            if w - x >= 6 and len(set(row[x:x + 6])) > 2:
                n = min(w - x, 20)
                nib = row[x:x + n] + [0] * (n % 2)
                b = bytes((nib[i] << 4) | nib[i + 1]
                          for i in range(0, len(nib), 2))
                out += bytes([0, n]) + b + b"\x00" * (len(b) % 2)
                x += n
                continue
            a, b2 = row[x], row[x + 1] if x + 1 < w else 0
            run = 1
            while x + run < w and run < 255 and \
                    row[x + run] == (a if run % 2 == 0 else b2):
                run += 1
            out += bytes([run, (a << 4) | b2])
            x += run
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def write_bmp_file(path, px, bits, palette=None, comp=0, top_down=False,
                   masks=None):
    """A BMP with a 40-byte header: 1-8 bit palette, RLE8 / RLE4, 16 bits
    (BI_BITFIELDS masks), 24 or 32 bits."""
    h, w = px.shape[:2]
    if comp in (1, 2):
        body = (_rle8 if comp == 1 else _rle4)(px)
    else:
        pitch = ((w * bits + 7) // 8 + 3) & ~3
        rows = px if top_down else px[::-1]
        if bits <= 8:
            b = ((rows[..., None] >> np.arange(bits - 1, -1, -1)) & 1
                 ).astype(np.uint8).reshape(h, -1)
            packed = np.packbits(b, axis=1)
        elif bits == 16:
            packed = rows.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            packed = rows.astype(np.uint8).reshape(h, -1)
        grid = np.zeros((h, pitch), np.uint8)
        grid[:, :packed.shape[1]] = packed
        body = grid.tobytes()
    pal = b""
    if palette is not None:
        pal = np.concatenate([palette[:, ::-1], np.zeros(
            (len(palette), 1), np.uint8)], 1).astype(np.uint8).tobytes()
    extra = struct.pack("<III", *masks) if masks else b""
    hdr = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits,
                      comp, len(body), 2835, 2835, 0, 0)
    off = 14 + len(hdr) + len(extra) + len(pal)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off)
                + hdr + extra + pal + body)


# ------------------------------------------------------------- PNM writer


def write_pnm_file(path, kind: str, values: np.ndarray, maxval: int = 255):
    """P1-P6 with a comment line; text files wrapped at 7 values."""
    h, w = values.shape[:2]
    header = f"{kind}\n# a fixture\n{w} {h}\n"
    if kind not in ("P1", "P4"):
        header += f"{maxval}\n"
    flat = values.reshape(-1)
    if kind in ("P1", "P2", "P3"):
        lines = [" ".join(str(v) for v in flat[i:i + 7])
                 for i in range(0, len(flat), 7)]
        body = ("\n".join(lines) + "\n").encode()
    elif kind == "P4":
        body = np.packbits(values.astype(np.uint8), axis=1).tobytes()
    else:
        body = flat.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(header.encode() + body)


# --------------------------------------------------------------- generate


# ------------------------------------------------- GIF, HDR, PFM, PAM, Sun
# raster and BigTIFF files, written byte by byte from each format's spec


def gif_pack(codes) -> bytes:
    """(code, width) pairs → LSB-first bytes, the last byte zero-padded."""
    acc = nbits = 0
    out = bytearray()
    for code, width in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def gif_codes(idx, mcs: int, clear_first=True, clear_when_full=True,
              end=True) -> list:
    """An LZW code stream for the indexes: (code, width) pairs, the width
    growing as a GIF decoder's table does; without ``clear_when_full`` a
    full table stays full (the deferred clear)."""
    clear, end_code = 1 << mcs, (1 << mcs) + 1
    out, size, nxt, table = [], mcs + 1, end_code + 1, {}
    if clear_first:
        out.append((clear, size))
    idx = [int(v) for v in np.asarray(idx).reshape(-1)]
    prefix = idx[0]
    for k in idx[1:]:
        if (prefix, k) in table:
            prefix = table[prefix, k]
            continue
        out.append((prefix, size))
        if nxt < 4096:
            table[prefix, k] = nxt
            if nxt == 1 << size and size < 12:
                size += 1
            nxt += 1
            if nxt == 4096 and clear_when_full:
                out.append((clear, 12))
                table, size, nxt = {}, mcs + 1, end_code + 1
        prefix = k
    out.append((prefix, size))
    if end:         # at the width the decoder reads after the last code
        if nxt == 1 << size and size < 12:
            size += 1
        out.append((end_code, size))
    return out


def gif_sub_blocks(data: bytes, n: int = 255) -> bytes:
    return b"".join(bytes([len(data[i:i + n])]) + data[i:i + n]
                    for i in range(0, len(data), n)) + b"\x00"


def gif_gce(disposal=0, transparent=None, size=4) -> bytes:
    flags = disposal << 2 | (transparent is not None)
    body = struct.pack("<BHB", flags, 10, transparent or 0)
    return b"\x21\xf9" + bytes([size]) + body.ljust(size, b"\x00") + b"\x00"


def gif_frame(idx, left=0, top=0, local=None, interlace=False, mcs=8,
              data=None, codes=None, block=255) -> bytes:
    """An image descriptor, its local table and its LZW sub-blocks (the
    indexes coded by ``gif_codes`` unless ``codes`` or raw ``data``)."""
    idx = np.asarray(idx)
    h, w = idx.shape
    flags, table = 0, b""
    if local is not None:
        flags |= 0x80 | (int(np.log2(len(local))) - 1)
        table = np.asarray(local, np.uint8).tobytes()
    if interlace:
        flags |= 0x40
        idx = idx[np.concatenate([np.arange(s, h, k) for s, k in
                                  ((0, 8), (4, 8), (2, 4), (1, 2))])]
    if data is None:
        data = gif_pack(codes if codes is not None else gif_codes(idx, mcs))
    return (b"\x2c" + struct.pack("<HHHHB", left, top, w, h, flags) + table
            + bytes([mcs]) + gif_sub_blocks(data, block))


def gif_file(w, h, table=None, bg=0, body=b"", version=b"89a",
             trailer=True) -> bytes:
    flags, raw = 0, b""
    if table is not None:
        flags = 0x80 | 0x70 | (int(np.log2(len(table))) - 1)
        raw = np.asarray(table, np.uint8).tobytes()
    return (b"GIF" + version + struct.pack("<HHBBB", w, h, flags, bg, 0)
            + raw + body + (b"\x3b" if trailer else b""))


def hdr_file(rgbe, header=b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
             size=None, flat=False) -> bytes:
    """(H, W, 4) RGBE bytes → a Radiance file: new-style run-length
    scanlines (runs of 4 or more, else literals of up to 128), or flat."""
    h, w = rgbe.shape[:2]
    out = bytearray(header + (size or f"-Y {h} +X {w}\n".encode()))
    for y in range(h):
        if flat:
            out += rgbe[y].tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            line, x = rgbe[y, :, c], 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and line[x + run] == line[x]:
                    run += 1
                if run >= 4:
                    out += bytes([128 + run, line[x]])
                    x += run
                    continue
                end = x
                while end < w and end - x < 128:
                    r = 1
                    while end + r < w and r < 4 and line[end + r] == line[end]:
                        r += 1
                    if r >= 4:
                        break
                    end += 1
                out += bytes([end - x]) + line[x:end].tobytes()
                x = end
    return bytes(out)


def pam_file(width, height, depth, maxval, samples, tupltype=None,
             lines=None) -> bytes:
    head = lines if lines is not None else [
        f"WIDTH {width}", f"HEIGHT {height}", f"DEPTH {depth}",
        f"MAXVAL {maxval}"] + ([f"TUPLTYPE {tupltype}"] if tupltype else [])
    dtype = ">u2" if maxval > 255 else np.uint8
    return (("P7\n" + "\n".join(head) + "\nENDHDR\n").encode()
            + np.asarray(samples).astype(dtype).tobytes())


def sunras_file(width, height, depth, rows: bytes, kind=1, maptype=0,
                cmap=b"") -> bytes:
    return struct.pack(">8I", 0x59A66A95, width, height, depth, len(rows),
                       kind, maptype, len(cmap)) + cmap + rows


_TIFF_TYPE_BYTES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
                    10: 8, 11: 4, 12: 8}


def to_bigtiff(data: bytes, long8: bool = True, offset_size: int = 8):
    """A classic TIFF → the same image as a BigTIFF: the bytes after the
    header moved 8 on, the first IFD rewritten with 20-byte entries (strip
    and tile offsets and counts as LONG8 with ``long8``)."""
    e = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(e + "I", data, 4)
    (n,) = struct.unpack_from(e + "H", data, ifd)
    body = bytearray(data[:2] + struct.pack(e + "HHHQ", 43, offset_size, 0,
                                            0)) + data[8:]
    entries = []
    for i in range(n):
        tag, typ, count = struct.unpack_from(e + "HHI", data, ifd + 2 + 12 * i)
        size = _TIFF_TYPE_BYTES.get(typ, 1) * count
        pos = ifd + 2 + 12 * i + 8
        if size > 4:
            (pos,) = struct.unpack_from(e + "I", data, pos)
        raw = data[pos:pos + size]
        if tag in (273, 279, 324, 325, 513):
            code = {3: "H", 4: "I"}[typ]
            vals = list(struct.unpack(e + code * count, raw))
            if tag in (273, 324, 513):
                vals = [v + 8 for v in vals]
            if long8 and tag != 513:
                typ, code = 16, "Q"
            raw = struct.pack(e + code * count, *vals)
        entries.append((tag, typ, count, raw))
    body += b"\x00" * (len(body) % 2)
    at = len(body)
    extra_at = at + 8 + 20 * len(entries) + 8
    extra, recs = bytearray(), []
    for tag, typ, count, raw in entries:
        if len(raw) > 8:
            recs.append(struct.pack(e + "HHQQ", tag, typ, count,
                                    extra_at + len(extra)))
            extra += raw + b"\x00" * (len(raw) % 2)
        else:
            recs.append(struct.pack(e + "HHQ", tag, typ, count)
                        + raw.ljust(8, b"\x00"))
    body += struct.pack(e + "Q", len(entries)) + b"".join(recs) + bytes(8)
    body += extra
    body[8:16] = struct.pack(e + "Q", at)
    return bytes(body)


def _cv2_write_padded(cv2, path, img):
    """cv2.imwrite of RGB ``img`` from a buffer with a zero byte after the
    image: cv2's Sun raster writer copies each row's pad byte from past the
    row, so the last one is that byte (the port writes 0 there)."""
    buf = np.zeros(img.size + 1, np.uint8)
    buf[:img.size] = img[..., ::-1].reshape(-1)
    assert cv2.imwrite(path, buf[:img.size].reshape(img.shape))


def generate_raster(folder: str = FOLDER):
    """The GIF, HDR, PFM, PAM, Sun raster and BigTIFF fixtures of CASES,
    REFUSED and ENCODED."""
    import cv2
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(14)
    img = fixture_image(20, 27, seed=5)
    h, w = img.shape[:2]
    p = lambda name: os.path.join(folder, name)       # noqa: E731

    def save(name, data):
        with open(p(name), "wb") as f:
            f.write(data)

    # GIF: every table size with its smallest code size, and code size 8
    for bits in range(1, 9):
        n = 1 << bits
        table = rng.integers(0, 256, (n, 3))
        idx = rng.integers(0, n, (h, w))
        idx[:, w // 2:] = idx[0, 0]           # long LZW strings
        save(f"gif_table{n}.gif", gif_file(w, h, table, 0, gif_frame(
            idx, mcs=max(bits, 2))))
    save("gif_table4_mcs8.gif", gif_file(w, h, rng.integers(0, 256, (4, 3)),
                                         1, gif_frame(rng.integers(
                                             0, 4, (h, w)), mcs=8)))
    pal16 = rng.integers(0, 256, (16, 3))
    idx16 = rng.integers(0, 16, (h, w))
    save("gif87a.gif", gif_file(w, h, pal16, 0, gif_frame(idx16, mcs=4),
                                version=b"87a"))
    save("gif_interlaced.gif", gif_file(w, h, pal16, 0, gif_frame(
        idx16, interlace=True, mcs=4)))
    Image.fromarray(img).convert("P").save(p("gif_pil_interlaced.gif"),
                                           interlace=True)
    frames = [Image.fromarray(np.roll(img, 5 * k, axis=1)).convert("P")
              for k in range(3)]
    frames[0].save(p("gif_animated.gif"), save_all=True,
                   append_images=frames[1:], duration=80, loop=0)
    pil = Image.fromarray(img).convert("P")
    pil.info["transparency"] = 7
    pil.save(p("gif_pil_transparent.gif"), transparency=7, disposal=2)
    save("gif_transparent_bg.gif", gif_file(w + 6, h + 4, pal16, 5, gif_gce(
        2, 3) + gif_frame(idx16, left=4, top=2, mcs=4)))
    save("gif_offset_frame.gif", gif_file(w + 9, h + 7, pal16, 9, gif_frame(
        idx16, left=5, top=3, mcs=4)))
    loc = rng.integers(0, 256, (32, 3))
    save("gif_local_table.gif", gif_file(w, h, pal16, 0, gif_frame(
        rng.integers(0, 32, (h, w)), local=loc, mcs=5)))
    save("gif_local_small.gif", gif_file(w, h, pal16, 0, gif_frame(
        idx16, local=loc[:4], mcs=4)))         # indexes 4-15 from global
    save("gif_local_only.gif", gif_file(w + 3, h + 2, None, 0, gif_frame(
        rng.integers(0, 32, (h, w)), left=1, top=1, local=loc, mcs=5)))
    save("gif_no_table.gif", gif_file(w, h, None, 0, gif_frame(
        rng.integers(0, 256, (h, w)), mcs=8)))
    noise = rng.integers(0, 256, (66, 68))     # more than 4096 codes
    save("gif_deferred_clear.gif", gif_file(68, 66, rng.integers(
        0, 256, (256, 3)), 0, gif_frame(noise, codes=gif_codes(
            noise, 8, clear_when_full=False))))
    save("gif_cleared_when_full.gif", gif_file(68, 66, rng.integers(
        0, 256, (256, 3)), 0, gif_frame(noise)))
    # cv2 reads an end code as a clear and decodes on
    half = idx16.reshape(-1)
    first = gif_codes(half[:200], 4)
    codes = first[:-1] + [(17, first[-1][1])] + gif_codes(half[200:], 4)
    save("gif_end_code_inside.gif", gif_file(w, h, pal16, 0, gif_frame(
        idx16, codes=codes, mcs=4)))
    save("gif_no_end_code.gif", gif_file(w, h, pal16, 0, gif_frame(
        idx16, codes=gif_codes(idx16, 4, end=False), mcs=4)))
    save("gif_one_byte_blocks.gif", gif_file(w, h, pal16, 0, gif_frame(
        idx16, mcs=4, block=1)))
    save("gif_extensions.gif", gif_file(w, h, pal16, 0, (
        b"\x21\xfe" + gif_sub_blocks(b"a comment") + b"\x21\x01"
        + gif_sub_blocks(bytes(12) + b"text") + b"\x21\xff"
        + gif_sub_blocks(b"XMP DataXMP" + bytes(20)) + b"\x21\xff\x0bNETSC"
        b"APE2.0\x03\x01\x05\x00\x00" + gif_gce(1)) + gif_frame(idx16,
                                                                mcs=4)))
    # one literal past the full frame, in the block's last byte: accepted
    lits = [(16, 5)] + [(int(v), 5) for v in half[:4]]
    save("gif_code_after_frame.gif", gif_file(2, 2, pal16, 0, gif_frame(
        half[:4].reshape(2, 2), codes=lits + [(16, 5), (3, 5)], mcs=4)))
    cv2.imwrite(p("gif_cv2.gif"), img[..., ::-1])
    base = gif_file(w, h, pal16, 0, gif_frame(idx16, mcs=4))
    save("gif_cut_trailer.gif", base[:-1])
    save("gif_cut_data.gif", base[:len(base) * 2 // 3])
    save("gif_short_data.gif", gif_file(w, h, pal16, 0, gif_frame(
        idx16, codes=gif_codes(half[:-3], 4), mcs=4)))
    save("gif_data_past_frame.gif", gif_file(w, h, pal16, 0, gif_frame(
        idx16, codes=gif_codes(np.concatenate([half, half[:9]]), 4),
        mcs=4)))
    save("gif_code_past_table.gif", gif_file(w, h, pal16, 0, gif_frame(
        idx16, codes=[(16, 5), (1, 5), (30, 5)] + gif_codes(half, 4)[1:],
        mcs=4)))
    save("gif_mcs12.gif", gif_file(w, h, pal16, 0, gif_frame(
        idx16, codes=gif_codes(idx16, 12), mcs=12)))
    save("gif_frame_outside.gif", gif_file(w, h, pal16, 0, gif_frame(
        idx16, left=2, mcs=4)))
    save("gif_index_past_table.gif", gif_file(w, h, pal16[:8], 0, gif_frame(
        idx16, mcs=4)))
    save("gif_disposal4.gif", gif_file(w, h, pal16, 0, gif_gce(4)
                                       + gif_frame(idx16, mcs=4)))
    save("gif_gce_size5.gif", gif_file(w, h, pal16, 0, gif_gce(0, size=5)
                                       + gif_frame(idx16, mcs=4)))
    save("gif_bg_past_table.gif", gif_file(w, h, pal16, 16, gif_frame(
        idx16, mcs=4)))
    save("gif_version88a.gif", gif_file(w, h, pal16, 0, gif_frame(
        idx16, mcs=4), version=b"88a"))

    # Radiance HDR
    cv2.imwrite(p("hdr_rle.hdr"), img[..., ::-1])
    cv2.imwrite(p("hdr_narrow.pic"), img[:, :6, ::-1])
    assert cv2.imwrite(p("hdr_flat.hdr"), img[..., ::-1],
                       [cv2.IMWRITE_HDR_COMPRESSION,
                        cv2.IMWRITE_HDR_COMPRESSION_NONE])
    rgbe = rng.integers(0, 256, (6, 11, 4)).astype(np.uint8)
    rgbe[:, :5] = rgbe[:, :1]
    rgbe[0, 0, 3] = 0                          # a zero exponent: black
    rgbe[1, :3, 3] = (200, 160, 137)           # past 255, past 2^31
    save("hdr_values.hdr", hdr_file(rgbe))
    save("hdr_rgbe_header.hdr", hdr_file(rgbe, b"#?RGBE\n# made here\n"
                                         b"GAMMA=2.2\nEXPOSURE=1.0\n"
                                         + b"X" * 200 + b"\n"
                                         b"FORMAT=32-bit_rle_rgbe\n\n",
                                         size=b"-Y 6  +X 11 trailing\n"))
    mixed = hdr_file(rgbe[:3]) + rgbe[3:].tobytes()
    save("hdr_rle_then_flat.hdr", mixed.replace(b"-Y 3 ", b"-Y 6 "))
    save("hdr_flat_wide.hdr", hdr_file(rgbe, flat=True))
    save("hdr_plus_y.hdr", hdr_file(rgbe, size=b"+Y 6 +X 11\n"))
    save("hdr_xyze.hdr", hdr_file(rgbe, b"#?RADIANCE\nFORMAT=32-bit_rle_xyze"
                                  b"\n\n"))
    good = hdr_file(rgbe)
    save("hdr_cut.hdr", good[:len(good) - 9])
    save("hdr_wrong_width.hdr", good.replace(b"\x02\x02\x00\x0b",
                                             b"\x02\x02\x00\x0c", 1))
    at = good.index(b"\x02\x02\x00\x0b") + 4
    save("hdr_bad_run.hdr", good[:at] + b"\x00" + good[at + 1:])

    # PFM
    cv2.imwrite(p("pfm_cv2.pfm"), img[..., ::-1])
    vals = np.array([0.5, 1.5, 2.5, -0.5, -3, np.nan, np.inf, -np.inf, 254.5,
                     255.5, 300, 1e10, 127.5, 3.49999, 77.7], np.float32)
    spec = np.stack([vals, vals[::-1], np.roll(vals, 4)], 1)[None]
    spec = np.concatenate([spec, spec[:, ::-1] * 2], 0)
    n = spec.shape[1]
    save("pfm_specials.pfm", f"PF\n{n} 2\n-1\n".encode()
         + spec.astype("<f4").tobytes())
    save("pfm_big_endian.pfm", f"PF\n{n} 2\n1.0\n".encode()
         + spec.astype(">f4").tobytes())
    save("pfm_scale.pfm", f"PF\n{n}\t2 -4\n".encode()
         + spec.astype("<f4").tobytes())
    save("pfm_gray.pfm", f"Pf\n{n} 2\n-1\n".encode()
         + spec[..., 0].astype("<f4").tobytes())
    save("pfm_scale0.pfm", f"PF\n{n} 2\n0\n".encode()
         + spec.astype("<f4").tobytes())
    save("pfm_cut.pfm", f"PF\n{n} 2\n-1\n".encode()
         + spec.astype("<f4").tobytes()[:-5])
    save("pfm_space_magic.pfm", f"PF {n} 2 -1\n".encode()
         + spec.astype("<f4").tobytes())

    # PAM
    cv2.imwrite(p("pam_cv2.pam"), img[..., ::-1])
    s8 = rng.integers(0, 256, (h, w, 4))
    s16 = rng.integers(0, 65536, (h, w, 4))
    save("pam_rgb.pam", pam_file(w, h, 3, 255, s8[..., :3], "RGB"))
    save("pam_rgb_notype.pam", pam_file(w, h, 3, 200, s8[..., :3] % 201))
    save("pam_gray.pam", pam_file(w, h, 1, 255, s8[..., 0], "GRAYSCALE"))
    save("pam_bw.pam", pam_file(w, h, 1, 1, s8[..., 0], "BLACKANDWHITE"))
    save("pam_bw_notype.pam", pam_file(w, h, 1, 1, s8[..., 0]))
    save("pam_rgb16.pam", pam_file(w, h, 3, 65535, s16[..., :3], "RGB"))
    save("pam_gray1000.pam", pam_file(w, h, 1, 1000, s16[..., 0] % 1001,
                                      "GRAYSCALE"))
    save("pam_ga_width1.pam", pam_file(1, h, 2, 255, s8[:, :1, :2],
                                       "GRAYSCALE_ALPHA"))
    save("pam_rgba_width1.pam", pam_file(1, h, 4, 65535, s16[:, :1],
                                         "RGB_ALPHA"))
    save("pam_header_order.pam", b"P7\r# comment\n\nTUPLTYPE RGB\t\n"
         b"MAXVAL 0255\nDEPTH  3 \nHEIGHT %d\nWIDTH %d\nENDHDR junk\n"
         % (h, w) + s8[..., :3].astype(np.uint8).tobytes())
    save("pam_ga_wide.pam", pam_file(w, h, 2, 255, s8[..., :2],
                                     "GRAYSCALE_ALPHA"))
    save("pam_rgba_wide.pam", pam_file(w, h, 4, 255, s8, "RGB_ALPHA"))
    save("pam_unknown_field.pam", pam_file(w, h, 3, 255, s8[..., :3],
                                           lines=[f"WIDTH {w}", "COLOR 3",
                                                  f"HEIGHT {h}", "DEPTH 3",
                                                  "MAXVAL 255"]))
    save("pam_width_twice.pam", pam_file(w, h, 3, 255, s8[..., :3],
                                         lines=[f"WIDTH {w}", f"WIDTH {w}",
                                                f"HEIGHT {h}", "DEPTH 3",
                                                "MAXVAL 255"]))
    save("pam_depth_mismatch.pam", pam_file(w, h, 3, 255, s8[..., :3],
                                            "GRAYSCALE"))
    save("pam_maxval65536.pam", pam_file(w, h, 3, 65536, s16[..., :3]))
    save("pam_plus_width.pam", pam_file(w, h, 3, 255, s8[..., :3],
                                        lines=[f"WIDTH +{w}", f"HEIGHT {h}",
                                               "DEPTH 3", "MAXVAL 255"]))
    save("pam_cut.pam", pam_file(w, h, 3, 255, s8[..., :3], "RGB")[:-7])

    # Sun raster
    _cv2_write_padded(cv2, p("ras_cv2.ras"), img)
    bgr = img[..., ::-1]
    pitch24 = (w * 3 + 1) & ~1
    rows24 = np.zeros((h, pitch24), np.uint8)
    rows24[:, :w * 3] = bgr.reshape(h, -1)
    save("ras_old_type.ras", sunras_file(w, h, 24, rows24.tobytes(), kind=0))
    rows32 = np.concatenate([rng.integers(0, 256, (h, w, 1)), bgr], 2)
    save("ras_32.ras", sunras_file(w, h, 32, rows32.astype(
        np.uint8).tobytes()))
    pitch8 = (w + 1) & ~1
    idx8 = rng.integers(0, 256, (h, pitch8)).astype(np.uint8)
    save("ras_8_gray.ras", sunras_file(w, h, 8, idx8.tobytes()))
    save("ras_8_map.ras", sunras_file(w, h, 8, idx8.tobytes(), maptype=1,
                                      cmap=rng.integers(0, 256, 768).astype(
                                          np.uint8).tobytes()))
    save("ras_8_short_map.ras", sunras_file(w, h, 8, (idx8 % 9).tobytes(),
                                            maptype=1, cmap=rng.integers(
                                                0, 256, 22).astype(
                                                np.uint8).tobytes()))
    pitch1 = ((w + 7) // 8 + 1) & ~1
    bits = rng.integers(0, 256, (h, pitch1)).astype(np.uint8).tobytes()
    save("ras_1.ras", sunras_file(w, h, 1, bits))
    save("ras_1_map.ras", sunras_file(w, h, 1, bits, maptype=1,
                                      cmap=bytes([200, 10, 100, 20, 50, 60])))
    save("ras_byte_encoded.ras", sunras_file(w, h, 8, bytes([0x80, 5, 7]) * 9,
                                             kind=2))
    save("ras_rgb_type.ras", sunras_file(w, h, 24, rows24.tobytes(), kind=3))
    save("ras_depth4.ras", sunras_file(w, h, 4, bytes(h * 14)))
    save("ras_cut.ras", sunras_file(w, h, 24, rows24.tobytes())[:-5])

    # BigTIFF: PIL's, and classic files moved into the BigTIFF layout
    Image.fromarray(img).save(p("bigtiff_pil.tif"), big_tiff=True)
    with tempfile.TemporaryDirectory() as tmp:
        t = lambda name: os.path.join(tmp, name)      # noqa: E731
        cv2.imwrite(t("lzw.tif"), img[..., ::-1])
        write_tiff_file(t("tiled.tif"), img, compression=8, predictor=2,
                        tile=(16, 16))
        write_tiff_file(t("planar.tif"), img, compression=5, planar=2,
                        rows_per_strip=7)
        write_tiff_file(t("be16.tif"), rng.integers(0, 65536, (h, w, 3)),
                        bps=16, compression=5, predictor=2, endian=">",
                        rows_per_strip=6)
        Image.fromarray(img).save(t("packbits.tif"), compression="packbits")
        for name, long8 in (("lzw", True), ("tiled", True), ("planar", False),
                            ("be16", True), ("packbits", True)):
            with open(t(f"{name}.tif"), "rb") as f:
                save(f"bigtiff_{name}.tif", to_bigtiff(f.read(), long8))
        with open(p("tiff_jpeg.tif"), "rb") as f:
            save("bigtiff_jpeg.tif", to_bigtiff(f.read()))
        with open(t("lzw.tif"), "rb") as f:
            save("bigtiff_offsets4.tif", to_bigtiff(f.read(),
                                                    offset_size=4))

    # the writers' sources and cv2's encodings of them
    src = fixture_image(23, 31, seed=9)
    for name in ("enc_src.gif", "enc_src.hdr", "enc_src.pfm", "enc_src.pam",
                 "enc_src.ras"):
        _cv2_write_padded(cv2, p(name), src)


def generate(folder: str = FOLDER):
    import cv2
    from PIL import Image

    from gsplat_tpu_torch.utils.image_io import write_png

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(12)
    img = fixture_image(seed=1)
    p = lambda name: os.path.join(folder, name)       # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        jsys, jpil = _jpeg_tools(tmp)
        big = fixture_image(61, 83, seed=2)      # enough scan data to cut
        jsys(os.path.join(tmp, "base.jpg"), big, "-q", "85", "-restart",
             "2")
        jsys(os.path.join(tmp, "prog.jpg"), big, "-q", "85", "-prog")
        with open(os.path.join(tmp, "base.jpg"), "rb") as f:
            base = f.read()
        with open(os.path.join(tmp, "prog.jpg"), "rb") as f:
            prog = f.read()
        cuts = {"jpeg_cut_baseline.jpg": _cut(base, 0.5)}
        for pct in (30, 60, 90):
            cuts[f"jpeg_cut_prog_{pct}.jpg"] = _cut(prog, pct / 100)
        for name, data in cuts.items():
            with open(p(name), "wb") as f:
                f.write(data)
        jsys(p("jpeg_arith_seq.jpg"), img, "-arith", "-q", "80",
             "-restart", "3", "-dac", "1", "3", "9")
        jsys(p("jpeg_arith_prog.jpg"), img, "-arith", "-prog", "-q", "90",
             "-restart", "2")
        Image.fromarray(img).convert("CMYK").save(p("jpeg_cmyk.jpg"),
                                                  quality=90)
        cmyk = np.concatenate([img, 255 - img[..., 1:2]], axis=2)
        jsys(p("jpeg_ycck.jpg"), cmyk, "-space", "ycck", "-q", "88")
        jpil(p("jpeg_lossless_p1.jpg"), img, "-lossless", "1", "0")
        jpil(p("jpeg_lossless_p7_pt2.jpg"), img, "-lossless", "7", "2",
             "-restart", str(W * 4))
        jpil(p("jpeg_lossless_cmyk.jpg"), cmyk, "-lossless", "4", "0")
        # refused by cv2: 12-bit, hierarchical, 2 components, lossless gray
        jpil(p("jpeg_12bit.jpg"), img.astype(np.uint16) * 16, "-prec", "12")
        plain = os.path.join(tmp, "plain.jpg")
        jsys(plain, img, "-q", "85")
        with open(plain, "rb") as f:
            data = f.read()
        sof = data.index(b"\xff\xc0")            # SOF0 -> SOF5
        with open(p("jpeg_hierarchical.jpg"), "wb") as f:
            f.write(data[:sof] + b"\xff\xc5" + data[sof + 2:])
        jsys(p("jpeg_2comp.jpg"), img[..., :2], "-q", "85")
        y, x = np.mgrid[0:840, 0:1297].astype(np.float64)
        view = np.stack([128 + 90 * np.sin(x / 70 + y / 110),
                         128 + 80 * np.cos(x / 50 - y / 90),
                         128 + 70 * np.sin((x + y) / 130)], axis=2)
        view += np.random.default_rng(3).normal(0, 2, view.shape)
        jsys(p(TIMING), np.clip(np.rint(view), 0, 255).astype(np.uint8),
             "-arith", "-prog", "-q", "90", "-restart", "64")
        jpil(p("jpeg_lossless_gray.jpg"), img[..., 0], "-lossless", "1",
             "0")

    # interlaced PNG
    write_adam7_png(p("png_adam7_rgb8.png"), img, 8, 2, seed=1)
    write_adam7_png(p("png_adam7_rgb16.png"),
                    rng.integers(0, 65536, (H, W, 3)), 16, 2, seed=2)
    pal = rng.integers(0, 256, (16, 3))
    write_adam7_png(p("png_adam7_palette.png"),
                    rng.integers(0, 16, (H, W, 1)), 4, 3, palette=pal, seed=3)
    write_adam7_png(p("png_adam7_gray2.png"), rng.integers(0, 4, (H, W, 1)),
                    2, 0, seed=4)

    # TIFF
    bgr = img[..., ::-1]
    T = cv2.IMWRITE_TIFF_COMPRESSION
    cv2.imwrite(p("tiff_none.tif"), bgr, [T, 1])
    cv2.imwrite(p("tiff_lzw.tif"), bgr)
    cv2.imwrite(p("tiff_deflate.tif"), bgr, [T, 8])
    cv2.imwrite(p("tiff_adobe_deflate.tif"), bgr, [T, 32946])
    cv2.imwrite(p("tiff_packbits.tif"), bgr, [T, 32773])
    cv2.imwrite(p("tiff_lzw_16.tif"),
                rng.integers(0, 65536, (H, W, 3)).astype(np.uint16))
    cv2.imwrite(p("tiff_gray_pred.tif"),
                (img[..., 0].astype(np.uint16) * 257 + rng.integers(
                    0, 257, (H, W))).astype(np.uint16), [T, 8])
    cv2.imwrite(p("tiff_jpeg.tif"), bgr, [T, 7])
    write_jpeg_tiff(p("tiff_jpeg_ycbcr.tif"), cv2.imencode(".jpg", bgr)[1]
                    .tobytes(), H, W, (2, 2))
    write_tiff_file(p("tiff_tiled.tif"), img, compression=5, predictor=2,
                    tile=(16, 16))
    write_tiff_file(p("tiff_planar.tif"), img, compression=8, predictor=2,
                    planar=2, rows_per_strip=7)
    write_tiff_file(p("tiff_big_endian.tif"),
                    rng.integers(0, 65536, (H, W, 3)), bps=16, compression=5,
                    predictor=2, endian=">", rows_per_strip=10)
    write_tiff_file(p("tiff_palette.tif"), rng.integers(0, 256, (H, W)),
                    photometric=3, compression=5,
                    colormap=rng.integers(0, 65536, (256, 3)))
    write_tiff_file(p("tiff_gray.tif"), img[..., 1], photometric=0,
                    compression=8, predictor=2)
    write_tiff_file(p("tiff_bilevel.tif"), rng.integers(0, 2, (H, W)), bps=1)
    write_tiff_file(p("tiff_rgba_unassoc.tif"),
                    rng.integers(0, 256, (H, W, 4)), compression=5,
                    extra_samples=[2])
    write_tiff_file(p("tiff_gray_alpha.tif"), rng.integers(0, 256, (H, W, 2)),
                    extra_samples=[2])
    write_tiff_file(p("tiff_palette2.tif"), rng.integers(0, 4, (H, W)),
                    bps=2, photometric=3,
                    colormap=rng.integers(0, 65536, (4, 3)))

    # BMP
    Image.fromarray(img).convert("P").save(p("bmp_pal8.bmp"))
    smooth = ((np.arange(W)[None] // 3 + np.arange(H)[:, None] // 2)
              % 256).astype(np.int64)
    smooth[::3, ::4] = rng.integers(0, 256, smooth[::3, ::4].shape)
    write_bmp_file(p("bmp_rle8.bmp"), smooth, 8, rng.integers(
        0, 256, (256, 3)), comp=1)
    write_bmp_file(p("bmp_rle4.bmp"), smooth % 16, 4, rng.integers(
        0, 256, (16, 3)), comp=2)
    write_bmp_file(p("bmp_pal1.bmp"), rng.integers(0, 2, (H, W)), 1,
                   rng.integers(0, 256, (2, 3)))
    cv2.imwrite(p("bmp_24.bmp"), bgr)
    Image.fromarray(np.concatenate([img, img[..., :1]], 2), "RGBA").save(
        p("bmp_32.bmp"))
    write_bmp_file(p("bmp_565.bmp"), rng.integers(0, 65536, (H, W)), 16,
                   comp=3, masks=(0xF800, 0x7E0, 0x1F))
    write_bmp_file(p("bmp_top_down.bmp"), img, 24, top_down=True)

    # PNM
    write_pnm_file(p("pnm_p1.pbm"), "P1", rng.integers(0, 2, (H, W)))
    write_pnm_file(p("pnm_p4.pbm"), "P4", rng.integers(0, 2, (H, W)))
    for kind in ("p2", "p3", "p5", "p6"):
        ch = 3 if kind in ("p3", "p6") else 1
        for maxval in (255, 7, 1000):
            vals = rng.integers(0, maxval + 1, (H, W, ch))
            ext = "ppm" if ch == 3 else "pgm"
            write_pnm_file(p(f"pnm_{kind}_{maxval}.{ext}"), kind.upper(),
                           vals, maxval)

    sha = generate_webp(folder)
    if sha != TIMING_WEBP_SHA256:
        print(f"TIMING_WEBP_SHA256 is now {sha!r}: update it")
    generate_raster(folder)
    shas = generate_jpeg2000(folder)
    if shas != TIMING_J2K:
        print(f"TIMING_J2K is now {shas!r}: update it")
    shas = generate_pyramid(folder)
    if shas != TIMING_CV2:
        print(f"TIMING_CV2 is now {shas!r}: update it")
    shas = generate_avif(folder)
    if shas != TIMING_AVIF:
        print(f"TIMING_AVIF is now {shas!r}: update it")
    _write_wants(CASES, folder)
    _check_cv2_refuses(folder)
    src = fixture_image(23, 31, seed=9)
    write_png(p("enc_src.png"), src)
    for name in ENCODED:
        _cv2_write_padded(cv2, p(name), src)


def _check_cv2_refuses(folder: str = FOLDER):
    import cv2

    for name in REFUSED:
        try:
            assert cv2.imread(os.path.join(folder, name)) is None, name
        except cv2.error:                     # cv2's size check raises
            pass
    for name in GARBLED + AVIF_UNPORTED:
        assert cv2.imread(os.path.join(folder, name)) is not None, name


def _want(name: str) -> str:
    return os.path.splitext(name)[0] + ".want.png"


def check(folder: str = FOLDER, scratch: str | None = None) -> dict:
    """The port's readers against the committed outputs: name -> True where
    ``read_image`` is bit for bit cv2's decode; for ``REFUSED``, where it
    raises naming the file (``GARBLED`` too, which cv2 reads only in part);
    for ``ENCODED``, ``ENCODED_J2K`` and ``ENCODED_J2K_RATE``, where the
    port's writer gives cv2's bytes; for ``RESIZED``, where
    ``downsample_area`` gives cv2.resize's pixels; for ``TIMING_CV2``,
    where the port's JP2 bytes and pyramids of TIMING's decode hash as
    cv2's; for ``ROUND_TRIP``, where the port's file reads back as its
    source; for ``AVIF_UNPORTED``, where it raises naming the file and
    saying it does not read the kind yet; for ``TIMING_AVIF``, where the
    decode hashes as cv2's.  ``scratch`` is a directory for the writers' files (a
    temporary one by default).  Warnings of cut-short files are expected
    and silenced."""
    import hashlib
    import warnings

    from gsplat_tpu_torch.downsample import downsample_area
    from gsplat_tpu_torch.utils.image_io import read_image, read_png, \
        write_bmp, write_gif, write_hdr, write_jpeg2000, write_pam, \
        write_pfm, write_pnm, write_sunras, write_tiff, write_webp

    out = {}
    for name in CASES:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = read_image(os.path.join(folder, name))
        want = read_png(os.path.join(folder, _want(name)))
        out[name] = got.shape == want.shape and bool((got == want).all())
    for name in REFUSED + GARBLED:
        try:
            read_image(os.path.join(folder, name))
            out[name] = False
        except (ValueError, RuntimeError) as err:
            out[name] = name in str(err)
    for name in AVIF_UNPORTED:
        try:
            read_image(os.path.join(folder, name))
            out[name] = False
        except RuntimeError as err:
            out[name] = name in str(err) and "not read yet" in str(err)
    for name, sha in TIMING_AVIF.items():
        got = np.ascontiguousarray(read_image(os.path.join(folder, name)))
        out[name] = hashlib.sha256(got.tobytes()).hexdigest() == sha
    src = read_png(os.path.join(folder, "enc_src.png"))
    writers = {".bmp": write_bmp, ".ppm": write_pnm, ".tif": write_tiff,
               ".gif": write_gif, ".hdr": write_hdr, ".pfm": write_pfm,
               ".pam": write_pam, ".ras": write_sunras}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        for name in ENCODED:
            path = os.path.join(tmp, name)
            writers[os.path.splitext(name)[1]](path, src)
            with open(path, "rb") as f, \
                    open(os.path.join(folder, name), "rb") as g:
                out[name] = f.read() == g.read()
        for name in ENCODED_J2K:
            path = os.path.join(tmp, name)
            write_jpeg2000(path, read_png(os.path.join(folder,
                                                       ENCODED_J2K_SRC)))
            with open(path, "rb") as f, \
                    open(os.path.join(folder, name), "rb") as g:
                out[name] = f.read() == g.read()
        for name, (source, x1000) in ENCODED_J2K_RATE.items():
            path = os.path.join(tmp, name)
            write_jpeg2000(path, read_png(os.path.join(folder, source)),
                           x1000)
            with open(path, "rb") as f, \
                    open(os.path.join(folder, name), "rb") as g:
                out[name] = f.read() == g.read()
        resize_src = read_png(os.path.join(folder, RESIZE_SRC))
        for name, factor in RESIZED.items():
            got = downsample_area(resize_src, factor)
            want = read_png(os.path.join(folder, name))
            out[name] = got.shape == want.shape and bool((got == want).all())
        view = read_image(os.path.join(folder, TIMING))
        path = os.path.join(tmp, "timing_default.jp2")
        write_jpeg2000(path, view, 250)
        with open(path, "rb") as f:
            data = {"timing_default.jp2": f.read()}
        for name in list(TIMING_CV2)[1:]:
            data[name] = downsample_area(view, _timing_factor(name)).tobytes()
        for name, b in data.items():
            out[name] = hashlib.sha256(b).hexdigest() == TIMING_CV2[name]
        for name in ROUND_TRIP:
            path = os.path.join(tmp, name)
            write_webp(path, src)
            back = read_image(path)
            out[name] = back.shape == src.shape and bool((back == src).all())
    return out


def _write_wants(names, folder: str = FOLDER):
    import cv2

    from gsplat_tpu_torch.utils.image_io import write_png

    for name in names:
        want = cv2.imread(os.path.join(folder, name))
        assert want is not None, name
        write_png(os.path.join(folder, _want(name)),
                  np.ascontiguousarray(want[..., ::-1]))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if sys.argv[1:] == ["--raster"]:        # GIF, HDR, PFM, PAM, Sun
        generate_raster()                   # raster and BigTIFF alone
        news = ("gif", "hdr_", "pfm_", "pam_", "ras_", "bigtiff_")
        _write_wants([n for n in CASES if n.startswith(news)])
        _check_cv2_refuses()
        result = check()
        print(result)
        sys.exit(0 if all(result.values()) else 1)
    if sys.argv[1:] == ["--jpeg2000"]:      # the JPEG 2000 fixtures alone
        shas = generate_jpeg2000()
        _write_wants(J2K_CASES)
        _check_cv2_refuses()
        print(f"TIMING_J2K = {shas!r}")
        result = check()
        print({k: v for k, v in result.items() if not v})
        sys.exit(0 if all(result.values()) else 1)
    if sys.argv[1:] == ["--pyramid"]:       # the rate-allocated JP2 and
        shas = generate_pyramid()           # INTER_AREA fixtures alone
        print(f"TIMING_CV2 = {shas!r}")
        result = check()
        print({k: v for k, v in result.items() if not v})
        sys.exit(0 if all(result.values()) else 1)
    if sys.argv[1:2] == ["--avif"]:         # the AVIF fixtures alone;
        shas = generate_avif(               # --avif SCENE also writes the
            mid_scene=(sys.argv[2:] or [None])[0])   # mid views' copies
        _write_wants(AVIF_CASES)
        _check_cv2_refuses()
        print(f"TIMING_AVIF = {shas!r}")
        result = check()
        print({k: v for k, v in result.items() if not v})
        sys.exit(0 if all(result.values()) else 1)
    if sys.argv[1:] == ["--webp"]:          # the WebP fixtures alone
        sha = generate_webp()
        _write_wants([n for n in CASES if n.endswith(".webp")])
        print(f"TIMING_WEBP_SHA256 = {sha!r}")
        sys.exit(0)
    generate()
    result = check()
    print(result)
    sys.exit(0 if all(result.values()) else 1)
