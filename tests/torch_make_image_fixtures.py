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
    python tests/torch_make_image_fixtures.py --inter  # AV1 frames after
                                                       # the first (libaom's
                                                       # encoder, ctypes)
    python tests/torch_make_image_fixtures.py --kinds  # the TIFF and JPEG
                                                       # kinds written here
                                                       # (KINDS_CASES; cv2)

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
``enc_src.png`` (WebP).  ``AVIF_INTER_CASES`` names the intra-only,
hidden and inter frames the port reads, ``AVIF_REBUILT_CASES`` the files
whose reference slots libaom rebuilds from ref_order_hint (the last kind
the port came to read), ``TIMING_AVIF`` the SHA-256s
of cv2's decodes of the full-size AVIF
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
# HT code-blocks (Part 15), CAP and CPF, JPH files and Part 2's CBD, MCT,
# MCC and MCO (tests/torch_j2k_ht.py's writer; libopenjp2's opj_set_MCT)
J2K_HT_CASES = [
    "j2k_ht_cleanup.j2k", "j2k_ht_refined.j2k", "j2k_ht_sigprop.j2k",
    "j2k_ht_97.j2k", "j2k_ht_layers_tiles.j2k", "j2k_ht_vsc_4x4.j2k",
    "j2k_ht_coc.j2k", "j2k_ht_cap_cpf.j2k", "j2k_ht.jph",
    "j2k_ht_gray16.jph", "j2k_part2_offsets.j2k", "j2k_part2_cbd.j2k",
]
J2K_HT_REFUSED = [
    "j2k_ht_roi.j2k", "j2k_ht_passes_past_set.j2k", "j2k_ht_mixed.j2k",
    "j2k_ht_cut.j2k", "j2k_part2_mct2.j2k",
]
CASES += J2K_HT_CASES
REFUSED += J2K_HT_REFUSED
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
# Pillow's two-frame image sequences (avis): libaom's good-quality mode at
# speed 2 (loop restoration), speed 4 with aq-mode=1 (segmentation), an
# RGBA one (an alpha track) and a 4:4:4 one at speed 3
AVIS_CASES = ["avis_pil_s2.avif", "avis_pil_s4_aq.avif",
              "avis_pil_alpha.avif", "avis_pil_444_s3.avif"]
AVIF_CASES += AVIS_CASES
# the colour and orientation kinds of Pillow's save options and hand
# edits: an ICC profile (a colr prof before the nclx) on a still and a
# sequence, EXIF orientations 2, 3 and 6 (imir, irot), an irot on cv2's file
# and an irot and imir in a sequence's sample entry, limited range (still
# and sequence), a premultiplied alpha (still and sequence), cv2's file
# with a colr prof then an nclx of BT.601 limited or BT.709 full (the
# repaired fault's files), cv2's 10- and 12-bit files with BT.709 limited
# and BT.2020 NCL full nclx, libavif's 10-bit 4:2:0 with a limited-range
# premultiplied alpha and its 12-bit 4:2:0 with an alpha; TIFF YCbCr and
# CIELab in each compression Pillow writes
AVIF_COLOUR_CASES = [
    "avif_pil_icc.avif", "avis_pil_icc.avif", "avif_pil_exif2.avif",
    "avif_pil_exif3.avif", "avif_pil_exif6.avif", "avif_irot.avif",
    "avis_irot_imir.avif", "avif_pil_limited.avif", "avis_pil_limited.avif",
    "avif_pil_prem.avif", "avis_pil_prem.avif",
    "avif_icc_nclx_601_limited.avif", "avif_icc_nclx_709_full.avif",
    "avif_d10_709_limited.avif", "avif_d12_2020_full.avif",
    "avif_d10_prem_limited_alpha.avif", "avif_d12_alpha.avif"]
TIFF_COLOUR_CASES = [f"tiff_{kind}_{comp}.tif" for kind in ("ycbcr", "lab")
                     for comp in ("none", "lzw", "deflate", "packbits")] + \
    ["tiff_ycbcr_sub22.tif", "tiff_ycbcr_sub42.tif"]
TIFF_COMPRESSIONS = {"none": None, "lzw": "tiff_lzw",
                     "deflate": "tiff_adobe_deflate", "packbits": "packbits"}
AVIF_CASES += AVIF_COLOUR_CASES
# the kinds of libavif's own path, its scaling and libaom's superres and
# delta loop filter (generate_libavif): superres at 8, 10 and 12 bits
# (4:2:0 with loop restoration, 4:4:4, 4:2:2) and in two tile columns,
# the delta loop filter (alone and with superres), the matrices libavif
# converts itself (SMPTE 240 as cv2 writes it and premultiplied, FCC,
# YCgCo, 15, YCgCo-Re at 10 bits, chroma-derived NCL of SMPTE 431 and
# EBU 3213 primaries, the identity matrix at limited range), a monochrome frame under a colour av1C (10 bits, limited range,
# 12 bits with an alpha), frames libavif scales (an item up and down, at
# 12 bits, a premultiplied alpha, grid tiles, a sequence's colour and
# alpha tracks by their tkhd), a scalability metadata OBU
AVIF_LIBAVIF_CASES = [
    "avif_superres_d8.avif", "avif_superres_d10_444.avif",
    "avif_superres_d12_422.avif", "avif_superres_tiles.avif",
    "avif_deltalf.avif", "avif_deltalf_superres_d10.avif",
    "avif_smpte240.avif", "avif_smpte240_prem_d10.avif", "avif_fcc.avif",
    "avif_ycgco.avif", "avif_m15.avif", "avif_ycgco_re_d10.avif",
    "avif_cdncl_p11.avif", "avif_cdncl_p22_limited.avif",
    "avif_identity_limited.avif",
    "avif_mono_frame_d10.avif", "avif_mono_frame_limited.avif",
    "avif_mono_frame_alpha_d12.avif",
    "avif_ispe_up.avif", "avif_ispe_down.avif", "avif_ispe_d12.avif",
    "avif_alpha_scaled_prem.avif", "avif_grid_scaled.avif",
    "avis_tkhd_scaled.avif", "avis_alpha_tkhd_scaled.avif",
    "avif_scalability.avif"]
AVIF_CASES += AVIF_LIBAVIF_CASES
# libavif refuses an item built from another item (construction method 2);
# libaom refuses avif_deltalf.avif with delta_lf_multi set by hand (its
# encoder never sets it: the symbols then read by four filters' CDFs end
# past the tile's trailing bit)
AVIF_REFUSED += ["avif_iloc_method2.avif", "avif_deltalf_multi.avif"]
# AV1 frames after the first (generate_inter): cv2's still item rewritten
# as an intra-only frame first and as a hidden key frame that a
# show_existing_frame header shows (torch_avif_oracles.frame_of_kind);
# libaom's good-quality encoder (torch_avif_oracles.libaom_encode_frames,
# the next slice's inter tools off: INTER_TOOLS_OFF) on 2-4 frames, each
# ending in a translated, in part darkened copy of its first: 8, 10 and 12
# bits in 4:2:0, 4:2:2 and 4:4:4, 4:0:0 at 8 and 10 bits; 128x128
# superblocks in 2x2 tiles; CDEF and loop restoration; cyclic refresh
# (segmentation with temporal update); film grain loaded from a reference
# (update_grain 0); speed 0 (the switchable filters); a hidden last inter
# frame that a show_existing_frame header shows (hide_last_frame)
AVIF_INTER_CASES = [
    "avif_intra_only.avif", "avif_hidden_key.avif",
    "avif_inter_d8_420.avif", "avif_inter_d8_422.avif",
    "avif_inter_d8_444.avif", "avif_inter_d10_420.avif",
    "avif_inter_d10_422.avif", "avif_inter_d10_444.avif",
    "avif_inter_d12_420.avif", "avif_inter_d12_422.avif",
    "avif_inter_d12_444.avif", "avif_inter_d8_400.avif",
    "avif_inter_d10_400.avif", "avif_inter_sb128_tiles.avif",
    "avif_inter_cdef_lr.avif", "avif_inter_seg_temporal.avif",
    "avif_inter_grain_ref.avif", "avif_inter_switchable.avif",
    "avif_inter_hidden.avif"]
AVIF_CASES += AVIF_INTER_CASES
# the inter tools libaom's encoder uses at its defaults (generate_inter_tools):
# the five files the inter slice found refused for motion-field projection,
# local warped motion, non-identity global motion, OBMC and inter-intra
# (each libaom's with that tool alone on); libaom's good-quality encoder at
# its default inter tools (but compound prediction's, and files that used
# skip mode passed over) on 4 frames at 8, 10 and 12 bits in every chroma
# format, speeds 0-6 and quantizers 12-52 (each taking temporal MV
# candidates), 128x128 superblocks in 2x2
# tiles, film grain; one file for each tool with that tool alone on (a seed
# search: the first file that uses it); a file whose frames are rotated and
# zoomed (warped_frames: global motion above a translation, warped); a
# one-bit flip of avif_tools_d8_444.avif that cv2 reads with a LOCALWARP
# block whose model is invalid (libaom's encoder writes none; a seeded
# search over flips)
AVIF_TOOLS_MOVED = ["avif_unported_ref_frame_mvs.avif",
                    "avif_unported_warped.avif", "avif_unported_global.avif",
                    "avif_unported_obmc.avif",
                    "avif_unported_interintra.avif"]
AVIF_TOOLS_FORMATS = [(d, f) for d in (8, 10, 12)
                      for f in ("420", "422", "444", "400")
                      if (d, f) != (12, "400")]
AVIF_TOOLS_ALONE = {"ref_frame_mvs": "enable-ref-frame-mvs",
                    "warped": "enable-warped-motion",
                    "global": "enable-global-motion",
                    "obmc": "enable-obmc",
                    "interintra_smooth": "enable-smooth-interintra",
                    "interintra_wedge": "enable-interintra-wedge"}
# each alone-on file's counter in tools_info
AVIF_TOOLS_COUNTER = {"ref_frame_mvs": 1, "warped": 2, "global": 5,
                      "obmc": 6, "interintra_smooth": 7,
                      "interintra_wedge": 8}
AVIF_TOOLS_CASES = AVIF_TOOLS_MOVED + [
    f"avif_tools_d{d}_{f}.avif" for d, f in AVIF_TOOLS_FORMATS] + [
    "avif_tools_sb128_tiles.avif", "avif_tools_grain.avif"] + [
    f"avif_tool_{t}.avif" for t in AVIF_TOOLS_ALONE] + [
    "avif_tools_rotzoom.avif", "avif_tools_invalid_warp.avif"]
AVIF_CASES += AVIF_TOOLS_CASES
# compound prediction and skip mode (generate_compound): the two files the
# inter slice found refused for them (libaom's, with enable-onesided-comp
# on and the other inter tools off); libaom's good-quality encoder at every
# default (compound_item: photo crops, 3-6 frames, speeds 0-2, where libaom
# takes compound prediction) at 8, 10 and 12 bits in every chroma format,
# every other file with libaom's default lookahead (a hidden ALTREF: a
# backward reference, bidirectional pairs); a file for each control of
# COMPOUND_TOOLS on alone (the masked types' with enable-masked-comp,
# which gates them, and the two-sided ones with the lookahead), its
# compound type in use; skip mode with a backward reference; a file whose
# single-reference blocks read their references beside compound ones (the
# neighbour counts of both references); each a seeded search for the first
# file that cv2 reads as the port does and whose last frame shown uses what
# it is for (the file cut after it: compound_prefix)
AVIF_COMPOUND_MOVED = ["avif_unported_compound.avif",
                       "avif_unported_skip_mode.avif"]
# each control alone: (the controls on over INTER_TOOLS_OFF, the lookahead,
# the compound_info counter that must be above 0)
AVIF_COMPOUND_ALONE = {
    "onesided": ({"enable-onesided-comp": 1}, 0, 0),
    "dist_wtd": ({"enable-dist-wtd-comp": 1}, 35, 1),
    "masked": ({"enable-masked-comp": 1}, 35, 0),
    "interinter_wedge": ({"enable-masked-comp": 1,
                          "enable-interinter-wedge": 1}, 35, 2),
    "diff_wtd": ({"enable-masked-comp": 1, "enable-diff-wtd-comp": 1}, 35,
                 3)}
AVIF_COMPOUND_CASES = AVIF_COMPOUND_MOVED + [
    f"avif_compound_d{d}_{f}.avif" for d, f in AVIF_TOOLS_FORMATS] + [
    f"avif_compound_{t}.avif" for t in AVIF_COMPOUND_ALONE] + [
    "avif_compound_skip_mode.avif", "avif_compound_neighbours.avif"]
AVIF_CASES += AVIF_COMPOUND_CASES
# frames predicted from references of another size, and switch frames
# (generate_scaled): the four files the inter slice found refused for a
# reference of another size, superres in an inter frame and in a
# reference (libaom's, generate_inter's searches) and a switch frame
# (switch_last_frame); libaom's resize (a key frame, then inter frames at
# 8/d of its size, d 9 or 16, the ends of libaom's range) at 8, 10 and 12
# bits in every chroma format; its superres of inter and key frames
# (1, d, d), of inter frames (1, d, 8) and of the key frame alone (1, 8, d)
# at d 9 and 16; compound blocks from a scaled reference (speed 0-2, with
# libaom's lookahead), OBMC blocks beside one; each a seeded search for the
# first file that cv2 reads as the port does and whose last frame shown
# uses what it is for (cut after it: compound_prefix over scaled_info);
# global motion that a
# scaled reference turns into a translation and a frame wider than its
# sequence's maximum (each an inter tools fixture's frame rewritten to
# another width: torch_avif_oracles.with_frame_size)
AVIF_SCALED_MOVED = ["avif_unported_ref_size.avif",
                     "avif_unported_superres_inter.avif",
                     "avif_unported_superres_ref.avif",
                     "avif_unported_switch.avif"]
AVIF_SUPERRES_KINDS = {"both": lambda d: (1, d, d),
                       "inter": lambda d: (1, d, 8),
                       "key": lambda d: (1, 8, d)}
AVIF_SCALED_CASES = AVIF_SCALED_MOVED + [
    f"avif_resize_d{d}_{f}.avif" for d, f in AVIF_TOOLS_FORMATS] + [
    f"avif_superres_{k}_{d}.avif" for k in AVIF_SUPERRES_KINDS
    for d in (9, 16)] + [
    "avif_scaled_compound.avif", "avif_scaled_obmc.avif",
    "avif_scaled_global.avif", "avif_scaled_over_max.avif"]
AVIF_CASES += AVIF_SCALED_CASES
# libaom's error resilient stream resized to half the key frame's width,
# its last frame's width rewritten one sample narrower (with_frame_size): a
# reference more than twice the frame, which libaom refuses
AVIF_SCALED_REFUSED = ["avif_ref_too_large.avif"]
# reference slots libaom rebuilds from ref_order_hint (generate_rebuilt):
# the file the inter slice found refused for it (libaom's error resilient
# stream resized to half the key frame's width, its last frame's LAST slot
# rewritten; generate_scaled writes it); libaom's own streams with one
# frame's hint rewritten (rebuilt_item): a slot the last frame's
# references name, at the frame's size ("named") and with the inter frames
# resized to half the key frame's ("scaled": the grey slot a 2x
# reference), and a slot whose buffer held a decoded frame, read by a later
# frame without error resilience ("leftover"), at 8, 10 and 12 bits in
# 4:2:0, 4:4:4 and 4:0:0; a slot no reference names; eight empty slots
# rebuilt by an error resilient intra-only frame first
# (torch_avif_oracles.full_headers); a show_existing_frame header of a
# rebuilt slot, plain and with the film grain its buffer kept
# (rebuilt_shown)
AVIF_REBUILT_MOVED = ["avif_unported_ref_order_hint.avif"]
AVIF_REBUILT_FORMATS = [(8, "420"), (10, "444"), (12, "420"), (8, "400")]
REBUILT_KINDS = ("named", "scaled", "leftover")
AVIF_REBUILT_CASES = AVIF_REBUILT_MOVED + [
    f"avif_rebuilt_{k}_d{d}_{f}.avif" for k in REBUILT_KINDS
    for d, f in AVIF_REBUILT_FORMATS] + [
    "avif_rebuilt_unnamed.avif", "avif_rebuilt_empty.avif",
    "avif_rebuilt_shown.avif", "avif_rebuilt_shown_grain.avif"]
AVIF_CASES += AVIF_REBUILT_CASES
# the rebuilt_info counter each file's decode must hold above 0 (blocks
# predicted from a rebuilt slot, reads of what its buffer kept; elsewhere
# the slots rebuilt)
AVIF_REBUILT_COUNTER = {
    "avif_unported_ref_order_hint.avif": 2,
    **{f"avif_rebuilt_{k}_d{d}_{f}.avif": 3 if k == "leftover" else 2
       for k in REBUILT_KINDS for d, f in AVIF_REBUILT_FORMATS},
    "avif_rebuilt_shown.avif": 3, "avif_rebuilt_shown_grain.avif": 3}
# libaom refuses: a rebuilt slot past twice the frame's size; a
# show_existing_frame of a rebuilt buffer no frame was decoded into (not
# showable); the primary reference frame of a frame in one (its entropy
# context uninitialised)
AVIF_REBUILT_REFUSED = ["avif_rebuilt_too_large.avif",
                        "avif_rebuilt_fresh_shown.avif",
                        "avif_rebuilt_fresh_primary.avif"]
REFUSED += AVIF_REBUILT_REFUSED
CASES += AVIF_CASES + TIFF_COLOUR_CASES
REFUSED += AVIF_REFUSED + AVIF_SCALED_REFUSED
# the TIFF and JPEG kinds cv2 reads beyond the others (kinds_files): 16-bit
# CIELab in every compression, with the predictor, in tiles, big-endian,
# rotated and under another white point; subsampled YCbCr under Predictor 2
# at each subsampling (strips; tiles whose predictor libtiff undoes and
# whose it leaves; an odd row of 4x4 blocks, which libtiff decodes short
# and leaves differenced;
# differences no reader undoes), and 4x4 tiles cut at the image's edge;
# old-style LZW (a long strip past 12-bit codes and CLEARs, the
# predictor, 16-bit big-endian gray, tiles, separate planes, FillOrder 2);
# lossless JPEG of subsampled components (interleaved with and without
# restarts, a scan a component, cut short); and what the TIFF sweep found
# besides: gray with an unassociated alpha in planes (libtiff's RGB way),
# 8-bit palette with an extra sample.  TIFF_KINDS_USES: what each
# file's counters show it took (read_tiff's and read_jpeg's ``info``).
TIFF_KINDS_USES = {
    "tiff_lab16_none.tif": "cielab16", "tiff_lab16_lzw_pred.tif": "cielab16",
    "tiff_lab16_deflate_pred.tif": "cielab16",
    "tiff_lab16_packbits.tif": "cielab16",
    "tiff_lab16_tiles_mm.tif": "cielab16",
    "tiff_lab16_orient3.tif": "cielab16", "tiff_lab16_orient6.tif": "cielab16",
    "tiff_lab16_white.tif": "cielab16",
    "tiff_ycbcr_pred_12.tif": "ycbcr_predictor_chunks",
    "tiff_ycbcr_pred_21.tif": "ycbcr_predictor_chunks",
    "tiff_ycbcr_pred_22.tif": "ycbcr_predictor_chunks",
    "tiff_ycbcr_pred_41.tif": "ycbcr_predictor_chunks",
    "tiff_ycbcr_pred_42.tif": "ycbcr_predictor_chunks",
    "tiff_ycbcr_pred_44.tif": "ycbcr_predictor_chunks",
    "tiff_ycbcr_pred_22_deflate.tif": "ycbcr_predictor_chunks",
    "tiff_ycbcr_pred_22_tiles.tif": "ycbcr_predictor_chunks",
    "tiff_ycbcr_pred_42_tiles.tif": "ycbcr_predictor_skipped",
    "tiff_ycbcr_pred_44_odd.tif": "ycbcr_predictor_skipped",
    "tiff_ycbcr_pred_pixels.tif": "ycbcr_predictor_chunks",
    "tiff_ycbcr_44_edge_tiles.tif": None,
    "tiff_lzw_old_rgb.tif": "old_lzw_chunks",
    "tiff_lzw_old_pred.tif": "old_lzw_chunks",
    "tiff_lzw_old_gray16_mm.tif": "old_lzw_chunks",
    "tiff_lzw_old_tiles.tif": "old_lzw_chunks",
    "tiff_lzw_old_planar.tif": "old_lzw_chunks",
    "tiff_lzw_old_fill2.tif": "old_lzw_chunks",
    "tiff_gray16_alpha_planar.tif": None, "tiff_palette_extra.tif": None,
    "jpeg_lossless_sub22.jpg": "subsampled_lossless",
    "jpeg_lossless_sub21_restart.jpg": "subsampled_lossless",
    "jpeg_lossless_sub_mixed.jpg": "subsampled_lossless",
    "jpeg_lossless_sub_scans.jpg": "subsampled_lossless",
    "jpeg_lossless_sub_cut.jpg": "subsampled_lossless",
}
KINDS_CASES = list(TIFF_KINDS_USES)
# the kinds cv2 refuses too (kinds_files): 16-bit YCbCr (subsampled or
# not), YCbCr and CIELab with an extra sample (8 and 16 bits), CIELab in
# separate planes, ICCLab and ITULab, old-style JPEG (compression 6), RGB
# of 5 samples (OpenCV reads at most 4), an uncompressed 16x16 RGB tile
# under FillOrder 2 (768 bytes, not whole KiB);
# arithmetic-coded lossless JPEG (SOF11, its scan Huffman-coded), a
# lossless restart interval that splits an MCU row, an interleaved scan
# of more than 10 samples an MCU
KINDS_REFUSED = [
    "tiff_refused_ycbcr16.tif", "tiff_refused_ycbcr16_sub.tif",
    "tiff_refused_ycbcr_extra.tif", "tiff_refused_ycbcr16_extra.tif",
    "tiff_refused_lab_extra.tif", "tiff_refused_lab16_extra.tif",
    "tiff_refused_lab_planar.tif", "tiff_refused_icclab.tif",
    "tiff_refused_itulab.tif", "tiff_refused_ojpeg.tif",
    "tiff_refused_rgb_5_samples.tif", "tiff_refused_fill2_tile.tif",
    "jpeg_refused_sof11.jpg", "jpeg_refused_split_restart.jpg",
    "jpeg_refused_mcu_samples.jpg"]
CASES += KINDS_CASES
REFUSED += KINDS_REFUSED
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
# Pillow's two-frame image sequences of TIMING (the second frame a copy of
# the first), cv2's decode of each: its default (speed 6: the full headers
# alone), speed 3 (switchable and self-guided loop restoration, 128x128
# superblocks, 2x2 tiles), speed 2 (Wiener units too) and aq-mode=1
# (segmentation); AVIS_OPTS holds each one's options
AVIS_OPTS = {
    "timing_avis_1297x840.avif": dict(),
    "timing_avis_s3_1297x840.avif": dict(speed=3),
    "timing_avis_s2_1297x840.avif": dict(speed=2),
    "timing_avis_aq_1297x840.avif": dict(advanced={"aq-mode": "1"}),
}
TIMING_AVIF.update({
    "timing_avis_1297x840.avif": ("da86f5983e6ed6a2b89820e6c55cfb00"
                                  "04987b2e57be35d2a20cb6421bb86cd0"),
    "timing_avis_s3_1297x840.avif": ("dac135648e016365f7f7e9f9a853042d"
                                     "70f6710648c030757e2dce7268bb8ab3"),
    "timing_avis_s2_1297x840.avif": ("2f3bfea530e13b4f834d2a581aac9736"
                                     "b2d81212754a6eefa7980a004fb724f0"),
    "timing_avis_aq_1297x840.avif": ("f7ff2d592a536f53365f7fe4d2bcc0be"
                                     "86dbdfc5a45b262e01b484d56bc431ff"),
})
# Pillow's files of TIMING in this slice's colour and orientation kinds:
# an ICC profile, limited range, RGBA with COLOUR_ALPHA premultiplied, an
# EXIF orientation 6 (irot), and cv2's default file with its nclx edited to
# BT.709 limited range; COLOUR_OPTS holds the options of Pillow's
COLOUR_TIMING = {"timing_icc_1297x840.avif": "icc",
                 "timing_limited_1297x840.avif": "limited",
                 "timing_prem_1297x840.avif": "prem",
                 "timing_irot_1297x840.avif": "exif6",
                 "timing_bt709_1297x840.avif": "bt709"}
TIMING_AVIF.update({
    "timing_icc_1297x840.avif": ("127eac07f5789c01fb9aa2a6e8b9459b"
                                 "71a900963f2b1fbdb9b1ad5adb078b70"),
    "timing_limited_1297x840.avif": ("d62ed9f82bbb332695144a7b8b4d0834"
                                     "506c065cc424b69a9938581593d8484f"),
    "timing_prem_1297x840.avif": ("2ec74a7437dff19ae790d4cf7f97311b"
                                  "df64487a9647cc06784464bfcc795b6f"),
    "timing_irot_1297x840.avif": ("127eac07f5789c01fb9aa2a6e8b9459b"
                                  "71a900963f2b1fbdb9b1ad5adb078b70"),
    "timing_bt709_1297x840.avif": ("c53a7de0aef29679655105fda5974707"
                                   "e3a32f66c50e26385390053745827e1d"),
})
# TIMING as Pillow's Deflate TIFF in YCbCr and in CIELab, the SHA-256 of
# cv2's decode of each
TIMING_TIFF = {
    "timing_ycbcr_1297x840.tif": ("243a71ca2f0c156eadbea8f98c92ad92"
                                  "8a114177b27876fc6813f1f08f4333cb"),
    "timing_lab_1297x840.tif": ("46fcaa9377609cad742ab103348d1f44"
                                "b5ef269cdac9430ed87bcfa072686d75"),
}
# full-size views of this slice's kinds (generate_libavif): libaom's
# superres (denominator 12, loop restoration) and delta loop filter
# (deltaq-mode 3) of TIMING, cv2's default file of it with a YCgCo nclx
# (libavif's own path, its bilinear chroma), and cv2's file of TIMING at
# 1040x672 under an ispe of 1297x840 (libavif scales it)
LIBAVIF_TIMING = ("timing_superres_1297x840.avif",
                  "timing_deltalf_1297x840.avif",
                  "timing_ycgco_1297x840.avif",
                  "timing_scaled_1297x840.avif")
TIMING_AVIF.update({
    "timing_superres_1297x840.avif": ("7b5f5755701e0cb899f9af83b2b5cda1"
                                      "adbef4075a4a763a57f92191ddb0947e"),
    "timing_deltalf_1297x840.avif": ("e75e1f0d1ac5077244b145a92be32511"
                                     "4fb97f083dad6498ebb4a9cae4850f02"),
    "timing_ycgco_1297x840.avif": ("f0bf2b82f569b4520ceb447ebcd17b84"
                                   "f64dc6ec5a5fc3b83980f7daeba888ae"),
    "timing_scaled_1297x840.avif": ("9384b685b395e7a94c945d2c20fefe87"
                                    "154ce5b8cf5d9ec85d7d98b9442682a3"),
})
# the full-size inter view (generate_inter): a key frame of TIMING
# translated by TIMING_INTER_SHIFT (rows, columns), then an inter frame of
# TIMING (libaom's good-quality encoder, speed 3, the next slice's inter
# tools off)
TIMING_INTER = "timing_inter_1297x840.avif"
TIMING_INTER_SHIFT = (3, -5)
TIMING_AVIF[TIMING_INTER] = ("a1fc231400adb1118b4bd47877efdc98"
                             "d2fd116d43adcc24cd37084e2e2004fd")
# the full-size view of libaom's default inter tools (generate_inter_tools):
# TIMING translated three times, twice and once by TIMING_INTER_SHIFT, then
# TIMING itself (speed 3; its last frame takes temporal MV candidates: in
# libaom's low-delay order the third frame's LAST counts as an overlay of
# its GOLDEN and nothing is projected onto it)
TIMING_TOOLS = "timing_tools_1297x840.avif"
TIMING_AVIF[TIMING_TOOLS] = ("b12a21884d251f30c3b30f3b7faa3abb"
                             "af6a4789dd1b7fbf3c83b7ae31f50e37")
# the full-size view of compound prediction (generate_compound): libaom at
# every default on noisy_frames of TIMING (moved by TIMING_INTER_SHIFT,
# sensor noise on each frame but the last), speed COMPOUND_SPEED, the
# noise's seed the first that makes libaom take compound and skip-mode
# blocks (seeds 0 and 1 make it take none)
TIMING_COMPOUND = "timing_compound_1297x840.avif"
TIMING_AVIF[TIMING_COMPOUND] = ("0b4669116111e9b923e63f87be3a94a7"
                                "89cee79d9cb14f9f394b6167a6eb8502")
# the full-size view of references of another size (generate_scaled):
# TIMING translated three times, twice and once by TIMING_INTER_SHIFT,
# then TIMING itself, libaom's inter frames coded at 8/12 of the key
# frame's size (resize (1, 12, 8); speed 3; libavif scales the last one to
# the ispe)
TIMING_RESIZE = "timing_resize_1297x840.avif"
TIMING_AVIF[TIMING_RESIZE] = ("17165dece7e5926b870799ba8d146831"
                              "97d76cdfa0e3dcda7fde94a3b3e16340")
# the full-size view of a reference slot rebuilt from ref_order_hint
# (generate_rebuilt, rebuilt_timing_view): TIMING translated twice and once
# by TIMING_INTER_SHIFT, then TIMING itself, libaom's error resilient
# frames (speed 6), the last one's first slot a block predicts from
# rebuilt neutral grey
TIMING_REBUILT = "timing_rebuilt_1297x840.avif"
TIMING_AVIF[TIMING_REBUILT] = ("03fc02a218f3f0bfe152a8560121fde5"
                               "bb7462b99f0dec994666d96bd4086777")
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
# Pillow's two-frame image sequences of the same views (the second frame a
# copy of the first): speeds 2, 3 and 4 in turn (loop restoration in every
# view), aq-mode=1 (segmentation) in every view k where k % 3 == k // 3 % 3
AVIF_MID_AVIS = "avif_mid_avis"


# Pillow's copies of the same views in the colour and orientation kinds,
# in turn by view (colour_mid_kind): an ICC profile, EXIF orientations 2, 3
# and 6, limited range, RGBA with COLOUR_ALPHA premultiplied
AVIF_MID_COLOUR = "avif_mid_colour"
COLOUR_MID_KINDS = ("icc", "exif2", "exif3", "exif6", "limited", "prem")
# copies of the same views in this slice's kinds, in turn by view
# (libavif_mid_file): libaom's superres (denominators 9-16), its delta
# loop filter, cv2's default file with an nclx libavif converts itself
# (SMPTE 240, YCgCo, FCC in turn)
AVIF_MID_LIBAVIF = "avif_mid_libavif"
LIBAVIF_MID_KINDS = ("superres", "deltalf", "libavif")
# key-frame-plus-inter copies of the same views (inter_mid_file: view k's
# key frame translated by inter_mid_shift(k), then an inter frame of it)
AVIF_MID_INTER = "avif_mid_inter"
# copies of the same views at libaom's default inter tools (tools_mid_file:
# a key frame of view k translated twice by inter_mid_shift(k), an inter
# frame of it translated once, then one of the view)
AVIF_MID_DEFAULT = "avif_mid_default"
# copies of the same views at every libaom default, compound prediction's
# too (compound_mid_file: noisy_frames of view k moved by
# inter_mid_shift(k): a key frame, then COMPOUND_MID_FRAMES - 1 inter
# frames, the last the view itself)
AVIF_MID_COMPOUND = "avif_mid_compound"
COMPOUND_MID_FRAMES = 4
# the sensor noise of noisy_frames (its standard deviation, 8-bit levels),
# libaom's speed and quantizer of the compound views (libaom takes compound
# prediction at speeds 0-2)
COMPOUND_NOISE, COMPOUND_SPEED, COMPOUND_CQ = 3.0, 1, 36
# copies of the same views whose inter frames predict from references of
# another size (scaled_mid_file): a key frame of view k translated twice by
# inter_mid_shift(k), then inter frames of it translated once and of the
# view, libaom's inter frames resized to 8/d (even k) or coded with
# superres at 8/d (odd k), d = 9 + k // 2 % 8
AVIF_MID_SCALED = "avif_mid_scaled"
# copies of the same views whose reference slots libaom rebuilds
# (rebuilt_mid_file): view k of kind REBUILT_KINDS[k % 3] ("named": the
# last frame's slot a block predicts from; "scaled": the same, the inter
# frames at half the key frame's size; "leftover": an earlier frame's,
# read by a later frame without error resilience); the SHA-256 of cv2's
# decode of each
AVIF_MID_REBUILT = "avif_mid_rebuilt"
REBUILT_MID_SHA256 = {
    "img_000.avif": ("69706199c753b8177038bc94e5043d6f"
                     "9e201a1484194196dc0ba2f4b6adec21"),
    "img_001.avif": ("ada1a2c79e81d52ea99fe9177bad836b"
                     "a1d8dd1d174e2b9a84540030485b4a33"),
    "img_002.avif": ("e4d10773ee8797840fb96a061d67fb31"
                     "4635a7ee01eb0dd55920a670b01d078b"),
    "img_003.avif": ("b6ceb6374db055780b91b731c68113af"
                     "3ea76b12ec1df699f9218db5d654ae2b"),
    "img_004.avif": ("30d5c31ebd619774fcd0a48445c96943"
                     "188150fc192f5b79e679bb84211b88fa"),
    "img_005.avif": ("257a386c69b96685169076a4d3918f81"
                     "41af11e055abc8f33b64a6314b5aa0ee"),
    "img_006.avif": ("500b922d341b05aa31390d2fb3bee6bf"
                     "7220bef9b8a977afb2c4033155769c81"),
    "img_007.avif": ("ce0d88ffc58944f2821b3e2e27219be0"
                     "17a3194118c831bd1ff90b74320e6268"),
    "img_008.avif": ("20a46152f29090595c36c417021e7c81"
                     "8ad8f9a912a49d9f423a42ac1f555ba3"),
    "img_009.avif": ("c9e0c9f9f4f22a89f473f5b03dc87917"
                     "6171cb4ffb904dcfab039fcb4adbbf67"),
    "img_010.avif": ("62fd2060055a4bd951d8e92da5d0d426"
                     "74f809de48a6a1c7aa5828efe67dec74"),
    "img_011.avif": ("d306ba81c08020680287f812d32e6be3"
                     "0e63bb964bab9d5c4467ec147065d81c"),
    "img_012.avif": ("a26748d6687be76d9d0c55f2bb7f3e3e"
                     "2329219c3bd0a01fac79cb6787e6ccc5"),
    "img_013.avif": ("058d5645358116d9098f18b2843a3a93"
                     "a24e60ce49c41848eb77baf5f4bbfacc"),
    "img_014.avif": ("0ab8735f9992e55bb9752e630dc8f02e"
                     "cca49cdd561d55c33d76f46779f0e5e1"),
    "img_015.avif": ("75e54240dbf83294401f371df25fff79"
                     "ec02862e6784d242a9c85a0550b78c3d"),
    "img_016.avif": ("a691763982ee161cb838705f31e33a55"
                     "a1a9ac5c83eec8da6c1df9a760f27369"),
    "img_017.avif": ("bad8196b1d0312808f5eaa7ee7a1aa80"
                     "9d7823929ca9e536cb3d6b18671c4b00"),
    "img_018.avif": ("2a1952f657b23900a4d9b20f5a5045a2"
                     "bf8ad0193a5b16a0d2c02bfb010730a9"),
    "img_019.avif": ("133286beace86162a26ca668093f167e"
                     "ec29dadc0e54f8290eb4380e7b03a1e5"),
    "img_020.avif": ("ff06409e0b3681f1afcee62dbfcd9661"
                     "ef550cb6f2caf0688e8199d4f04d41cd"),
    "img_021.avif": ("f03098f7069c9aaae7508570d4666d44"
                     "1a21ad6222277eb0708c1ce3ff8e3b2e"),
    "img_022.avif": ("70d27a329be52b5d7208954edf739200"
                     "ce2dc9fa94c9dabd3e1bef96b36eab0e"),
    "img_023.avif": ("90621a1695df48c6ca95ce1f9578ec35"
                     "6c064311ea6d4265fe851962fd001ce2")}
# chip_smoke's tiff_mid_kinds views (tiff_mid_file), written on the card's
# host from the decodes of AVIF_MID's views: view k as 16-bit CIELab
# (Deflate, Predictor 2) for k % 3 == 0, as 4:2:0 YCbCr under LZW and
# Predictor 2 for k % 3 == 1, as old-style LZW RGB for k % 3 == 2; the
# SHA-256 of cv2's decode of each
TIFF_MID_KINDS = ("cielab16", "ycbcr_predictor_chunks", "old_lzw_chunks")
TIFF_MID_SHA256 = {
    "img_000.tif": ("277426976267d09f15cfff2dff225390"
                    "88b1792a76ae2a5db32c764754efc548"),
    "img_001.tif": ("e19f98b4f51bd33b3f4be806ea9f5566"
                    "26872122f76d3dff3d5733e4dfd692f9"),
    "img_002.tif": ("36af7acc3cab5357b753aa08d0f50551"
                    "88bdb175a05ca2e290b0cc392e106d15"),
    "img_003.tif": ("42223674edb414348c4a1b32b34e53cf"
                    "952d37a90396d516a7b82179a9caab91"),
    "img_004.tif": ("df6f3119daa0d648ffd83d362145f2f3"
                    "9293de83e244858496b9f5ca05a28681"),
    "img_005.tif": ("0ea1ced50cbb4d9a0829e9bb0d55c324"
                    "db9ce885d83660479b56504dc02cfd63"),
    "img_006.tif": ("64cf8f80ba02bb0a70ff4d827f7ec82a"
                    "d70003cea7a4472ee0fabb595cdf287d"),
    "img_007.tif": ("ba5369a69c4a331598f01c8237fa992d"
                    "ca0a53b6d0da975581ce21c496fb2f47"),
    "img_008.tif": ("742cdb872c0c59af0931a87bea59b87b"
                    "b4f3e1eb16346a80e3e283f4685047e0"),
    "img_009.tif": ("4f1d7fb8306d15202c390cd48a9340a2"
                    "103778203cbfcbf6480a04d5b57df7de"),
    "img_010.tif": ("95d08cdca7aaf29f9b07751d74773e6a"
                    "8674e53625ef8523f6650bf9ff90c403"),
    "img_011.tif": ("4700f3ae85cadb320f61c9f67edb0d1d"
                    "7d30dc45a2822bac2e635bec4ff52d5b"),
    "img_012.tif": ("af40a5690362509f10b7d73bb48ba469"
                    "58b4dc79d4ff69773dd65e402ca53bc1"),
    "img_013.tif": ("ba2c657321c9a9cd13257cc9af59e28c"
                    "fbe890b3971be98628d1b049c351a3ce"),
    "img_014.tif": ("206dad91465c7f3f9e171364ba3e1a43"
                    "a31935394f39da5ae0da8d000abc8583"),
    "img_015.tif": ("4a69e3dcbcad78fc6a10a16d15bc98e9"
                    "14558b8d7cd7e12813dfdd9723da6780"),
    "img_016.tif": ("3ec093c5161be4341936ef93b69d8fe4"
                    "e383f85ee327d68ae3a0d82708845aa3"),
    "img_017.tif": ("601ab850ae246ce47c8f57e2a158650c"
                    "cd223d0cd11c1a389234aac167a9f6aa"),
    "img_018.tif": ("ccc7f5038a2207cf1dccd2e8e9bd9671"
                    "41f6427be4dfbaffbc142e54623e4ce6"),
    "img_019.tif": ("4725d12243bece3c19330f62f4456b60"
                    "4ded599ebc41c4fb83a0956b48cc8a7f"),
    "img_020.tif": ("7047787f45aea34511cd3754ffebc3ed"
                    "0a39f929b470437de3bb7d53943801b4"),
    "img_021.tif": ("d30946eb386c88d9a521f87f17ff90d6"
                    "4c7305c814af0a316a9232cfa30ed964"),
    "img_022.tif": ("723f27fa6f904668686a8728ba466ec1"
                    "48f3a18473496f0693d75fdef4e3cf32"),
    "img_023.tif": ("4240c13f75921e071b71ac0d160c2545"
                    "27b4e2d3b549c10e12342df883e84a72"),
}
# chip_smoke's j2k_mid_ht leg: AVIF_MID's decodes written in turn as a raw
# codestream of HT code-blocks (cleanup passes at plane 0, 5/3, RCT) and as
# a JPH file whose blocks' SigProp and MagRef passes finish plane 0
# (torch_j2k_ht.j2k_mid_file); the SHA-256 of cv2's decode of each (the
# AVIF decode itself: both are lossless)
J2K_MID_KINDS = ("cleanup", "refined")
J2K_MID_SHA256 = {
    "img_000.j2c": ("d1137773bab93dbaac0205b62e30998b"
                    "c5035838565d542ea092e5653fef5777"),
    "img_001.jph": ("7deec60a06452a0a6ec3c5b8b9b7b8f1"
                    "50bb341437a74ef79c7e34b945deb9f1"),
    "img_002.j2c": ("36af7acc3cab5357b753aa08d0f50551"
                    "88bdb175a05ca2e290b0cc392e106d15"),
    "img_003.jph": ("6740e19f56d2e00494c27dd4386dd3f4"
                    "2f61c02dbd8b79c8619dd8d70cf57b5c"),
    "img_004.j2c": ("74f065ba3ad5dfe8921e19bce87c8dbb"
                    "37d661e9ae99bbec962e5acfe274dd30"),
    "img_005.jph": ("0ea1ced50cbb4d9a0829e9bb0d55c324"
                    "db9ce885d83660479b56504dc02cfd63"),
    "img_006.j2c": ("a545d0e2908afc097dc2a1685a548724"
                    "44cbdd4bc7e0f9b92fefddf377b6fdbe"),
    "img_007.jph": ("c2f44bb36ca2bdb1c44e178be0f32ce6"
                    "afab6c098c9a3a5948faf9067c0b7283"),
    "img_008.j2c": ("742cdb872c0c59af0931a87bea59b87b"
                    "b4f3e1eb16346a80e3e283f4685047e0"),
    "img_009.jph": ("97f07614f7c16df3a148c0529583e1b0"
                    "670e1210927f68793352b497ac795ed1"),
    "img_010.j2c": ("769701b9d6f7e405205157daae072b80"
                    "39b55ea88067f50f7e70e05396d1fe9f"),
    "img_011.jph": ("4700f3ae85cadb320f61c9f67edb0d1d"
                    "7d30dc45a2822bac2e635bec4ff52d5b"),
    "img_012.j2c": ("4a3e7f80b9f760d1725dbdd4f1d64a80"
                    "7806abad10874231559c4d73f6bb6104"),
    "img_013.jph": ("8460021db4b9f7d61cc003eb542989d1"
                    "90d66a0a1abc0d6b507d9fe84cc84aa0"),
    "img_014.j2c": ("206dad91465c7f3f9e171364ba3e1a43"
                    "a31935394f39da5ae0da8d000abc8583"),
    "img_015.jph": ("cc12422feb979311306c292ae561c95a"
                    "34d2d4780645f08728ac0c32991185cc"),
    "img_016.j2c": ("8b70e345c135b7c1165e80c300e0557c"
                    "8ef70dd3be579bc13f9472668eea9563"),
    "img_017.jph": ("601ab850ae246ce47c8f57e2a158650c"
                    "cd223d0cd11c1a389234aac167a9f6aa"),
    "img_018.j2c": ("ac09c2b74ca5167a7cc634d77ac81ba3"
                    "13ad5cd8ecd005c2d44519d3b87b1545"),
    "img_019.jph": ("3d459a9d9567f711e029d9f01a74ecc5"
                    "675336b93089d36c67a5d556f452941b"),
    "img_020.j2c": ("7047787f45aea34511cd3754ffebc3ed"
                    "0a39f929b470437de3bb7d53943801b4"),
    "img_021.jph": ("51e0e532488f222e22b970302cfcc961"
                    "1909fff97889cd9926909d67fc3db15d"),
    "img_022.j2c": ("26dcd1040c0e27475d5a09b268a0158e"
                    "569adc442870a2fba21b352d57b3f4af"),
    "img_023.jph": ("4240c13f75921e071b71ac0d160c2545"
                    "27b4e2d3b549c10e12342df883e84a72"),
}
# the JPH of TIMING's decode (j2k_mid_file(view, 1)): cv2's decode, hashed
TIMING_JPH_SHA256 = ("5ecbfcd59d9427c8264c980ed02f3158"
                     "fd7ccab4bbd671247d8ec3a1e4c505f6")


def colour_alpha(h: int, w: int) -> np.ndarray:
    """(h, w) uint8: the alpha of the premultiplied views, 128-255 in a
    diagonal ramp."""
    y, x = np.mgrid[:h, :w]
    return (128 + (x + 2 * y) * 127 // max(w - 1 + 2 * (h - 1), 1)).astype(
        np.uint8)


def colour_file(bgr: np.ndarray, kind: str, sequence: bool = False
                ) -> bytes:
    """Pillow's file (a two-frame sequence with ``sequence``) of a BGR view
    in one of the colour and orientation kinds: "icc", "exif2", "exif3",
    "exif6", "limited", "prem" (COLOUR_ALPHA premultiplied)."""
    import torch_avif_oracles as oracle

    write = oracle.pillow_sequence if sequence else oracle.pillow_avif
    if kind == "icc":
        return write(bgr, icc_profile=oracle.icc_profile())
    if kind.startswith("exif"):
        return write(bgr, exif=oracle.orientation_exif(int(kind[4:])))
    if kind == "limited":
        return write(bgr, range="limited")
    assert kind == "prem", kind
    return write(np.dstack([bgr, colour_alpha(*bgr.shape[:2])]),
                 alpha_premultiplied=True)


def avis_mid_opts(k: int) -> dict:
    """Pillow's options for the avis copy of mid view k."""
    opts = dict(speed=2 + k % 3)
    if k % 3 == k // 3 % 3:
        opts["advanced"] = {"aq-mode": "1"}
    return opts


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
                    tile_parts=None, extra=None, mct_array=None) -> bytes:
    """A codestream (or, with jp2, a JP2 file) from the system libopenjp2's
    encoder (2.5.0 here; ctypes over openjpeg.h's structures): ``planes``
    are the components' sample arrays; ``mode`` the code-block style bits
    (1 BYPASS, 2 RESET, 4 TERMALL, 8 VSC, 16 PTERM, 32 SEGSYM); ``layers``
    rates, one a layer (none: one lossless layer); ``pocs`` (resno0,
    compno0, layno1, resno1, compno1, order) tuples; ``csty`` 2 SOP, 4 EPH;
    ``tile_parts`` 'R', 'L' or 'C'; ``extra`` options such as 'PLT=YES' or
    'TLM=YES'; ``mct_array`` (matrix, offsets) through ``opj_set_MCT``: the
    Part 2 array-based transform (the 9/7, COD's MCT byte 2, and the CBD,
    MCT, MCC and MCO markers).  Raises when the library refuses the
    parameters."""
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
    if mct_array is not None:
        mat = (c.c_float * (n * n))(*np.asarray(mct_array[0], np.float32)
                                    .ravel().tolist())
        off = (c.c_int32 * n)(*[int(v) for v in mct_array[1]])
        lib.opj_set_MCT.argtypes = [c.POINTER(params_t), c.c_void_p,
                                    c.c_void_p, c.c_uint32]
        if not lib.opj_set_MCT(c.byref(p), mat, off, n):
            raise RuntimeError("libopenjp2 refused the MCT array")
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

def j2k_mid_file(rgb: np.ndarray, k: int, stats=None) -> bytes:
    """View k of chip_smoke's j2k_mid_ht leg (torch_j2k_ht.j2k_mid_file):
    even k a raw codestream of HT cleanup passes, odd k a JPH file whose
    SigProp and MagRef passes finish plane 0; both lossless."""
    import torch_j2k_ht

    return torch_j2k_ht.j2k_mid_file(rgb, k, stats)


def generate_j2k_ht(folder: str = FOLDER) -> tuple:
    """The fixtures of J2K_HT_CASES and J2K_HT_REFUSED; returns
    (J2K_MID_SHA256, TIMING_JPH_SHA256): the SHA-256 of cv2's decode of
    each j2k_mid_file view of AVIF_MID's decodes, and of the JPH of
    TIMING's decode (both lossless: cv2's decode is the source)."""
    import hashlib

    import cv2
    import torch_j2k_ht as ht

    from gsplat_tpu_torch.utils.image_io import read_avif

    img = fixture_image(seed=21)
    h, w = img.shape[:2]
    pl = [img[..., k] for k in range(3)]
    p = lambda name: os.path.join(folder, name)       # noqa: E731

    def save(name, data):
        with open(p(name), "wb") as f:
            f.write(data)
    rng = np.random.default_rng(22)
    co = [(rng.integers(-500, 501, (h, w)) * (rng.random((h, w)) < 0.7))
          for _ in range(3)]
    save("j2k_ht_cleanup.j2k", ht.ht_codestream(pl, numres=3, mct=1))
    save("j2k_ht_refined.j2k", ht.ht_codestream(pl, numres=3, passes=3,
                                                plane=1, fallback=False))
    save("j2k_ht_sigprop.j2k", ht.ht_codestream(pl, numres=2, passes=2,
                                                plane=2))
    save("j2k_ht_97.j2k", ht.ht_codestream(
        coeffs=[co], size=(h, w), numres=3, reversible=False, qstyle=1,
        expn=12, mant=900, passes=3, plane=2))
    save("j2k_ht_layers_tiles.j2k", ht.ht_codestream(
        pl, numres=3, tiles=(16, 24), layers=3,
        layer_of=lambda *k: sum(k) % 3, precincts=[(3, 3), (4, 4), (4, 4)],
        cblk=(2, 3), prog="RLCP", sop=True, eph=True, passes=3, plane=1))
    save("j2k_ht_vsc_4x4.j2k", ht.ht_codestream(pl, numres=2, cblk=(2, 2),
                                                style=0x48, passes=3,
                                                plane=1, fallback=False))
    theirs = ht.part1_packets(pl, 3)
    save("j2k_ht_coc.j2k", ht.ht_codestream(
        pl, numres=3, style=0, coc_styles={1: 0x40}, passes=3, plane=1,
        packets_of=lambda t, l, r, c, q: None if c == 1 else theirs[(r, c)]))
    save("j2k_ht_cap_cpf.j2k", ht.ht_codestream(
        pl, numres=2, cap=ht.cap_marker(bytes(range(9))),
        cpf=ht.cpf_marker((0x4000, 0x1234))))
    cs = ht.ht_codestream(pl, numres=3, passes=3, plane=1)
    save("j2k_ht.jph", ht.jph_file(cs, 3, h, w))
    gray = (pl[1].astype(np.int64) << 8) + rng.integers(0, 256, (h, w))
    save("j2k_ht_gray16.jph", ht.jph_file(
        ht.ht_codestream([gray], prec=16, numres=3, passes=3, plane=1), 1,
        h, w, colr=17, bpc=15))
    part2 = openjpeg_encode(pl, mct_array=(np.eye(3), (30, -40, 7)))
    ms, rest = ht.main_markers(part2)
    for code, body in ms:
        if code == 0xFF52:
            body[4] = 0
    save("j2k_part2_offsets.j2k", ht.join_markers(ms, rest))
    at = next(i for i, m in enumerate(ms) if m[0] == 0xFF78)
    save("j2k_part2_cbd.j2k", ht.join_markers(
        ms[:at] + [ht.cbd([9, 7, 9])] + ms[at + 1:], rest))
    # what cv2 refuses
    save("j2k_part2_mct2.j2k", part2)
    save("j2k_ht_roi.j2k", ht.ht_codestream(pl, numres=2, rgn=(0, 3)))
    save("j2k_ht_passes_past_set.j2k", ht.ht_codestream(
        pl, numres=2, passes=3, plane=1, extra_passes=3))
    save("j2k_ht_mixed.j2k", ht.ht_codestream(pl, numres=2, style=0xC0))
    whole = ht.ht_codestream(pl, numres=3, passes=3, plane=1)
    save("j2k_ht_cut.j2k", whole[:len(whole) * 6 // 10])
    # the mid views and the timing JPH
    mid = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(folder, AVIF_MID)
        for k, name in enumerate(sorted(os.listdir(src))):
            view = read_avif(os.path.join(src, name))
            ext = ".jph" if k % 2 else ".j2c"
            out = os.path.join(tmp, name[:-5] + ext)
            with open(out, "wb") as f:
                f.write(j2k_mid_file(view, k))
            dec = np.ascontiguousarray(cv2.imread(out)[..., ::-1])
            assert (dec == view).all(), name
            mid[name[:-5] + ext] = hashlib.sha256(dec.tobytes()).hexdigest()
        view = np.ascontiguousarray(cv2.imread(p(TIMING))[..., ::-1])
        out = os.path.join(tmp, "timing.jph")
        with open(out, "wb") as f:
            f.write(j2k_mid_file(view, 1))
        dec = np.ascontiguousarray(cv2.imread(out)[..., ::-1])
        assert (dec == view).all()
        timing = hashlib.sha256(dec.tobytes()).hexdigest()
    return mid, timing


def generate_avif(folder: str = FOLDER, mid_scene: str | None = None
                  ) -> dict:
    """The AVIF fixtures of AVIF_CASES, AVIF_REFUSED and
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


def generate_avis(folder: str = FOLDER, mid_scene: str | None = None
                  ) -> dict:
    """The image sequence fixtures: AVIS_CASES, avis_tkhd_scaled.avif,
    AVIS_OPTS's timing views (and, given the folder of make_synth_scene
    --preset mid, AVIF_MID_AVIS's views); returns the timing views'
    SHA-256s of cv2's decodes."""
    import hashlib

    import cv2

    import torch_avif_oracles as oracle

    p = lambda name: os.path.join(folder, name)       # noqa: E731

    def save(name, data):
        with open(p(name), "wb") as f:
            f.write(data)
    rng = np.random.default_rng(23)
    big = oracle.avif_image("photo", 72, 104, rng)
    save("avis_pil_s2.avif", oracle.pillow_sequence(oracle.avif_image(
        "photo", 160, 208, np.random.default_rng(160)), speed=2))
    save("avis_pil_s4_aq.avif", oracle.pillow_sequence(
        big, speed=4, advanced={"aq-mode": "1"}))
    save("avis_pil_alpha.avif", oracle.pillow_sequence(
        np.dstack([big, big[..., 1:2]]), speed=4))
    save("avis_pil_444_s3.avif", oracle.pillow_sequence(
        big, speed=3, subsampling="4:4:4"))
    samples, props, w, h, _ = oracle.sequence_parts(
        oracle.pillow_sequence(big))[0]
    save("avis_tkhd_scaled.avif", oracle.build_sequence(
        samples, props, w, h, tkhd_size=(w // 2, h // 2)))
    view = cv2.imread(p(TIMING))
    shas = {}
    for name, opts in AVIS_OPTS.items():
        save(name, oracle.pillow_sequence(view, **opts))
        dec = np.ascontiguousarray(cv2.imread(p(name))[..., ::-1])
        shas[name] = hashlib.sha256(dec.tobytes()).hexdigest()
    if mid_scene is not None:
        src = os.path.join(mid_scene, "images_4")
        os.makedirs(p(AVIF_MID_AVIS), exist_ok=True)
        for k, name in enumerate(sorted(os.listdir(src))):
            bgr = cv2.imread(os.path.join(src, name))
            save(os.path.join(AVIF_MID_AVIS, name[:-4] + ".avif"),
                 oracle.pillow_sequence(bgr, **avis_mid_opts(k)))
    return shas


def ycbcr_subsampled_tiff(px: np.ndarray, hs: int, vs: int, rps: int,
                          compression: int = 1, planar: bool = False
                          ) -> bytes:
    """A TIFF of 8-bit YCbCr samples (H, W, 3) with chroma subsampling hs x
    vs (tag 530), as no writer here makes one: strips of ``rps`` rows of
    data units (hs · vs luma samples, then the block's Cb and Cr: the
    top-left sample's), blocks past the edge padded with the edge's
    samples; uncompressed or Deflate (8); with ``planar`` (1 x 1 only) the
    three planes' strips one after another (tag 284 = 2)."""
    h, w = px.shape[:2]
    strips = []
    for plane in range(3 if planar else 0):
        for y0 in range(0, h, rps):
            data = px[y0:y0 + rps, :, plane].tobytes()
            strips.append(zlib.compress(data) if compression == 8 else data)
    for y0 in range(0, 0 if planar else h, rps):
        rows = px[y0:min(h, y0 + rps)]
        unit = bytearray()
        for by in range(0, rows.shape[0], vs):
            for bx in range(0, w, hs):
                for yy in range(vs):
                    for xx in range(hs):
                        unit.append(rows[min(by + yy, rows.shape[0] - 1),
                                         min(bx + xx, w - 1), 0])
                unit += bytes(rows[by, bx, 1:])
        strips.append(zlib.compress(bytes(unit)) if compression == 8
                      else bytes(unit))
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [8, 8, 8]),
            259: (3, [compression]), 262: (3, [6]), 273: (4, None),
            277: (3, [3]), 278: (3, [rps]), 279: (4, [len(x) for x in strips]),
            284: (3, [2 if planar else 1]), 530: (3, [hs, vs])}
    head = 8 + 2 + 12 * len(tags) + 4
    extra = bytearray()
    where = {}
    data_at = head + 64 + 8 * len(strips)
    offsets, at = [], data_at
    for x in strips:
        offsets.append(at)
        at += len(x)
    tags[273] = (4, offsets)
    out = bytearray(b"II*\0" + struct.pack("<IH", 8, len(tags)))
    for t in sorted(tags):
        typ, vals = tags[t]
        raw = struct.pack(f"<{len(vals)}{'H' if typ == 3 else 'I'}", *vals)
        if len(raw) > 4:
            where[t] = head + len(extra)
            extra += raw
            out += struct.pack("<HHII", t, typ, len(vals), where[t])
        else:
            out += struct.pack("<HHI", t, typ, len(vals)) + raw.ljust(4,
                                                                    b"\0")
    out += b"\0" * 4 + extra
    out += b"\0" * (data_at - len(out))
    return bytes(out) + b"".join(strips)


def generate_colour(folder: str = FOLDER, mid_scene: str | None = None
                    ) -> dict:
    """The colour and orientation fixtures: AVIF_COLOUR_CASES,
    TIFF_COLOUR_CASES, avif_smpte240.avif, COLOUR_TIMING's views and
    TIMING_TIFF's (and, given the folder of make_synth_scene --preset mid,
    AVIF_MID_COLOUR's views); returns the SHA-256s of cv2's decodes of the
    timing views."""
    import hashlib
    import io

    import cv2
    from PIL import Image

    import torch_avif_oracles as oracle

    p = lambda name: os.path.join(folder, name)       # noqa: E731

    def save(name, data):
        with open(p(name), "wb") as f:
            f.write(data)
    rng = np.random.default_rng(29)
    big = oracle.avif_image("photo", 72, 104, rng)
    for kind in ("icc", "limited", "prem"):
        save(f"avif_pil_{kind}.avif", colour_file(big, kind))
        save(f"avis_pil_{kind}.avif", colour_file(big, kind, True))
    for value in (2, 3, 6):
        save(f"avif_pil_exif{value}.avif", colour_file(big, f"exif{value}"))
    samples, props, w, h, _ = oracle.sequence_parts(
        oracle.pillow_sequence(big))[0]
    save("avis_irot_imir.avif", oracle.build_sequence(
        samples, props, w, h, extra=[oracle.box(b"irot", b"\x01"),
                                     oracle.box(b"imir", b"\x01")]))
    cv2_file = oracle.cv2_avif(oracle.avif_image("photo", 48, 64, rng))
    prof = oracle.box(b"colr", b"prof" + oracle.icc_profile())
    save("avif_icc_nclx_601_limited.avif", oracle.with_colr(
        cv2_file, [prof, oracle.nclx(1, 13, 6, False)]))
    save("avif_icc_nclx_709_full.avif", oracle.with_colr(
        cv2_file, [prof, oracle.nclx(1, 13, 1, True)]))
    deep = oracle.deepen(big, rng)
    save("avif_d10_709_limited.avif", oracle.with_colr(
        oracle.cv2_avif(deep, depth=10), [oracle.nclx(1, 1, 1, False)]))
    save("avif_d12_2020_full.avif", oracle.with_colr(
        oracle.cv2_avif(deep, depth=12), [oracle.nclx(9, 16, 9, True)]))
    for depth, prem, full in ((10, True, False), (12, False, True)):
        yuv = deep.astype(np.int64) >> (16 - depth)
        colour = oracle.libavif_encode([yuv[..., 0], yuv[::2, ::2, 1],
                                        yuv[::2, ::2, 2]], depth, "420")
        alpha = oracle.libavif_encode([rng.integers(
            0, 1 << depth, big.shape[:2])], depth, "400", full)
        name = f"avif_d{depth}_prem_limited_alpha.avif" if prem else \
            f"avif_d{depth}_alpha.avif"
        save(name, oracle.alpha_file(colour, alpha, prem))
    save("avif_smpte240.avif", oracle.with_colr(
        cv2_file, [oracle.nclx(1, 13, 7, True)]))
    rgb = fixture_image(40, 56, seed=31)
    for kind, mode in (("ycbcr", "YCbCr"), ("lab", "LAB")):
        for comp, pil_comp in TIFF_COMPRESSIONS.items():
            buf = io.BytesIO()
            Image.fromarray(rgb).convert(mode).save(buf, "TIFF",
                                                    compression=pil_comp)
            save(f"tiff_{kind}_{comp}.tif", buf.getvalue())
    for hs, vs in ((2, 2), (4, 2)):
        save(f"tiff_ycbcr_sub{hs}{vs}.tif", ycbcr_subsampled_tiff(
            rng.integers(0, 256, (37, 45, 3)).astype(np.uint8), hs, vs, 6))
    # the full-size views
    view = cv2.imread(p(TIMING))
    shas = {}
    for name, kind in COLOUR_TIMING.items():
        if kind == "bt709":
            save(name, oracle.with_colr(oracle.cv2_avif(view),
                                        [oracle.nclx(1, 1, 1, False)]))
        else:
            save(name, colour_file(view, kind))
    for name, mode in (("timing_ycbcr_1297x840.tif", "YCbCr"),
                       ("timing_lab_1297x840.tif", "LAB")):
        buf = io.BytesIO()
        Image.fromarray(view[..., ::-1]).convert(mode).save(
            buf, "TIFF", compression="tiff_adobe_deflate")
        save(name, buf.getvalue())
    for name in list(COLOUR_TIMING) + ["timing_ycbcr_1297x840.tif",
                                       "timing_lab_1297x840.tif"]:
        dec = np.ascontiguousarray(cv2.imread(p(name))[..., ::-1])
        shas[name] = hashlib.sha256(dec.tobytes()).hexdigest()
    if mid_scene is not None:
        src = os.path.join(mid_scene, "images_4")
        os.makedirs(p(AVIF_MID_COLOUR), exist_ok=True)
        for k, name in enumerate(sorted(os.listdir(src))):
            bgr = cv2.imread(os.path.join(src, name))
            save(os.path.join(AVIF_MID_COLOUR, name[:-4] + ".avif"),
                 colour_file(bgr, COLOUR_MID_KINDS[k % len(
                     COLOUR_MID_KINDS)]))
    return shas


def yuv_planes(bgr: np.ndarray, matrix: int) -> list:
    """8-bit full-range 4:2:0 planes of a BGR image in matrix coefficients
    6 (BT.601), 7 (SMPTE 240), 4 (FCC) or 8 (YCgCo), for libaom_encode
    (chroma the mean of each 2x2 block, rounded)."""
    b, g, r = (bgr[..., k].astype(np.float64) for k in range(3))
    if matrix == 8:
        y = r / 4 + g / 2 + b / 4
        u = -r / 4 + g / 2 - b / 4 + 128
        v = r / 2 - b / 2 + 128
    else:
        kr, kb = {6: (0.299, 0.114), 7: (0.212, 0.087),
                  4: (0.30, 0.11)}[matrix]
        y = kr * r + (1 - kr - kb) * g + kb * b
        u = (b - y) / (2 * (1 - kb)) + 128
        v = (r - y) / (2 * (1 - kr)) + 128
    h, w = y.shape

    def sub(c):
        c = np.pad(c, ((0, h % 2), (0, w % 2)), mode="edge")
        return (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] +
                c[1::2, 1::2]) / 4
    return [np.clip(np.rint(a), 0, 255).astype(np.int64)
            for a in (y, sub(u), sub(v))]


def libavif_mid_file(bgr: np.ndarray, k: int) -> bytes:
    """View k of AVIF_MID_LIBAVIF: LIBAVIF_MID_KINDS in turn."""
    import torch_avif_oracles as oracle

    kind = LIBAVIF_MID_KINDS[k % len(LIBAVIF_MID_KINDS)]
    if kind == "libavif":
        matrix = (7, 8, 4)[(k // 3) % 3]
        return oracle.encoded_avif(yuv_planes(bgr, matrix), 8, 1, 1,
                                   controls={"cq-level": 20},
                                   colr=oracle.nclx(1, 13, matrix, True))
    planes = yuv_planes(bgr, 6)
    if kind == "superres":
        d = 9 + (k // 3) % 8
        return oracle.encoded_avif(planes, 8, 1, 1, superres=(1, d, d),
                                   controls={"cq-level": 20,
                                             "enable-restoration": 1})
    return oracle.encoded_avif(planes, 8, 1, 1, controls={
        "cq-level": 20, "deltaq-mode": 3, "deltalf-mode": 1})


def generate_libavif(folder: str = FOLDER, mid_scene: str | None = None
                     ) -> dict:
    """This slice's fixtures: AVIF_LIBAVIF_CASES (but avif_smpte240.avif
    and avis_tkhd_scaled.avif, which generate_colour and generate_avis
    write), avif_iloc_method2.avif, LIBAVIF_TIMING's views
    (and, given the folder of make_synth_scene --preset mid,
    AVIF_MID_LIBAVIF's views); returns the SHA-256s of cv2's decodes of
    the timing views."""
    import hashlib

    import cv2

    import torch_avif_oracles as oracle
    from gsplat_tpu_torch.utils.image_io import decode_av1

    p = lambda name: os.path.join(folder, name)       # noqa: E731

    def save(name, data):
        with open(p(name), "wb") as f:
            f.write(data)
    rng = np.random.default_rng(41)
    photo = oracle.avif_image("photo", 100, 150, rng)
    sub = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}

    def planes(img, depth, fmt):
        a = oracle.deepen(img, rng).astype(np.int64) >> (16 - depth)
        sx, sy = sub[fmt]
        return [a[..., 0], a[::1 + sy, ::1 + sx, 1], a[::1 + sy, ::1 + sx, 2]]
    # superres and the delta loop filter (libaom's own encoder)
    for name, depth, fmt, denom in (("avif_superres_d8.avif", 8, "420", 13),
                                    ("avif_superres_d10_444.avif", 10,
                                     "444", 9),
                                    ("avif_superres_d12_422.avif", 12,
                                     "422", 16)):
        save(name, oracle.encoded_avif(
            planes(photo, depth, fmt), depth, *sub[fmt],
            superres=(1, denom, denom),
            controls={"enable-restoration": 1, "cq-level": 24}))
    wide = oracle.avif_image("photo", 64, 520, rng)
    save("avif_superres_tiles.avif", oracle.encoded_avif(
        yuv_planes(wide, 6), 8, 1, 1, superres=(1, 12, 12),
        controls={"enable-restoration": 1, "tile-columns": 1,
                  "cq-level": 30}))
    big = oracle.avif_image("photo", 160, 300, rng)
    deltalf = oracle.encoded_avif(yuv_planes(big, 6), 8, 1, 1, controls={
        "deltaq-mode": 3, "deltalf-mode": 1, "cq-level": 40})
    save("avif_deltalf.avif", deltalf)
    stream, _ = oracle.item_parts(deltalf)
    info = decode_av1(stream)[1]
    bit = 8 * info[23] + info[45] + 3          # delta_lf_multi
    edit = bytearray(deltalf)
    at = len(deltalf) - len(stream) + bit // 8
    edit[at] |= 0x80 >> (bit % 8)
    save("avif_deltalf_multi.avif", bytes(edit))
    save("avif_deltalf_superres_d10.avif", oracle.encoded_avif(
        planes(big, 10, "420"), 10, 1, 1, superres=(1, 11, 11), controls={
            "deltaq-mode": 3, "deltalf-mode": 1, "cq-level": 40}))
    # libavif's own conversion
    cv2_file = oracle.cv2_avif(oracle.avif_image("photo", 48, 64, rng))
    for name, nclx in (("avif_fcc.avif", (1, 13, 4, True)),
                       ("avif_ycgco.avif", (1, 13, 8, True)),
                       ("avif_m15.avif", (1, 13, 15, True)),
                       ("avif_cdncl_p11.avif", (11, 13, 12, True)),
                       ("avif_cdncl_p22_limited.avif", (22, 13, 12, False))):
        save(name, oracle.with_colr(cv2_file, [oracle.nclx(*nclx)]))
    deep = oracle.deepen(photo, rng)
    yuv = deep.astype(np.int64) >> 6
    save("avif_ycgco_re_d10.avif", oracle.with_colr(oracle.libavif_encode(
        [yuv[..., 0] >> 2, yuv[..., 1], yuv[..., 2]], 10, "444"),
        [oracle.nclx(1, 13, 16, True)]))
    save("avif_identity_limited.avif", oracle.with_colr(
        oracle.libavif_encode([yuv[..., 0], yuv[..., 1], yuv[..., 2]], 10,
                              "444", False), [oracle.nclx(1, 13, 0, False)]))
    colour = oracle.with_colr(oracle.libavif_encode(
        [yuv[..., 0], yuv[::2, ::2, 1], yuv[::2, ::2, 2]], 10, "420"),
        [oracle.nclx(1, 13, 7, True)])
    alpha = oracle.libavif_encode([rng.integers(0, 1024, photo.shape[:2])],
                                  10, "400")
    save("avif_smpte240_prem_d10.avif", oracle.alpha_file(colour, alpha,
                                                          True))
    # a monochrome frame under a colour av1C
    gray = photo[..., 1]

    def colour_av1c(data: bytes) -> bytes:
        s, e = oracle.find_box(data, (b"meta", b"iprp", b"ipco"))
        at = [bs for k, _, bs, _ in oracle.boxes(data, s + 8, e)
              if k == b"av1C"][0]
        d = bytearray(data)
        d[at + 2] &= ~0x10
        return bytes(d)
    save("avif_mono_frame_d10.avif", colour_av1c(oracle.cv2_avif(
        gray.astype(np.uint16) << 2, 60, 10)))
    save("avif_mono_frame_limited.avif", oracle.with_colr(colour_av1c(
        oracle.cv2_avif(gray, 60)), [oracle.nclx(1, 13, 6, False)]))
    g12 = oracle.libavif_encode([gray.astype(np.int64) << 4], 12, "400")
    a12 = oracle.libavif_encode([rng.integers(0, 4096, gray.shape)], 12,
                                "400")
    keep = [(b, e) for b, e in oracle.item_props(g12, 1)
            if b[4:8] not in (b"av1C", b"colr")]
    aprops = [(b, e) for b, e in oracle.item_props(a12, 1)
              if b[4:8] != b"colr"] + [(oracle.ALPHA_AUXC, False)]
    save("avif_mono_frame_alpha_d12.avif", oracle.build_items(
        [(1, b"av01", oracle.item_parts(g12)[0],
          keep + [(oracle.av1c_box(12, 1, 1), True),
                  (oracle.nclx(1, 13, 1, True), False)]),
         (2, b"av01", oracle.item_parts(a12)[0], aprops)],
        [(b"auxl", 2, [1]), (b"prem", 1, [2])]))
    # frames libavif scales

    def with_ispe(data, w, h):
        obu, _ = oracle.item_parts(data)
        props = [(oracle.ispe_box(w, h) if b[4:8] == b"ispe" else b, e)
                 for b, e in oracle.item_props(data, 1)]
        return oracle.build_items([(1, b"av01", obu, props)], [])
    small = oracle.avif_image("photo", 48, 64, rng)
    save("avif_ispe_up.avif", with_ispe(oracle.cv2_avif(small), 100, 75))
    save("avif_ispe_down.avif", with_ispe(oracle.cv2_avif(small), 24, 18))
    save("avif_ispe_d12.avif", with_ispe(oracle.cv2_avif(
        oracle.deepen(small, rng) >> 4, 60, 12), 90, 40))
    rgba = np.dstack([small, rng.integers(0, 256, (48, 64)).astype(
        np.uint8)])
    cobu, cprops, _, aprops = oracle.alpha_parts(oracle.pillow_avif(
        rgba, alpha_premultiplied=True))
    tiny = np.dstack([small[::2, ::2], rng.integers(
        0, 256, (24, 32)).astype(np.uint8)])
    aobu = oracle.alpha_parts(oracle.pillow_avif(tiny))[2]
    save("avif_alpha_scaled_prem.avif", oracle.build_items(
        [(1, b"av01", cobu, cprops), (2, b"av01", aobu, aprops)],
        [(b"auxl", 2, [1]), (b"prem", 1, [2])]))
    tiles = [oracle.tile_item(oracle.cv2_avif(t)) for t in oracle.split_tiles(
        oracle.avif_image("photo", 64, 96, rng), 2, 3, 32, 32)]
    tiles = [(obu, [(oracle.ispe_box(64, 64) if b[4:8] == b"ispe" else b, e)
                    for b, e in props]) for obu, props in tiles]
    save("avif_grid_scaled.avif", oracle.grid_avif(tiles, 2, 3, 192, 128))
    seq = oracle.pillow_sequence(rgba)
    (samples, props, w, h, _), (asamples, aprops2, *_) = \
        oracle.sequence_parts(seq)[:2]
    save("avis_alpha_tkhd_scaled.avif", oracle.build_sequence(
        samples, props, w, h, tkhd_size=(96, 72), alpha=(asamples, aprops2),
        alpha_tkhd_size=(96, 72), prem_by=2))
    # the container and stream kinds
    obu, props = oracle.item_parts(cv2_file)
    parts = [oracle.obu(t, p) for t, _, p in oracle.obus(obu)]
    bits = "00001110" + "01" + "100" + "000" + "0000000010000000" * 4 + "1"
    bits += "0" * (-len(bits) % 8)
    meta = oracle.obu(5, bytes([3]) + int(bits, 2).to_bytes(len(bits) // 8,
                                                             "big"))
    save("avif_scalability.avif", oracle.build_avif(
        b"".join(parts[:2]) + meta + b"".join(parts[2:]), props))
    method = bytearray(oracle.build_avif(obu, props, iloc_version=1))
    method[method.find(b"iloc") + 15] = 2
    save("avif_iloc_method2.avif", bytes(method))
    still, sprops = oracle.item_parts(oracle.cv2_avif(
        oracle.avif_image("photo", 96, 128, rng)))
    for kind in ("intra_only", "hidden_key"):
        save(f"avif_{kind}.avif", oracle.build_avif(
            oracle.frame_of_kind(still, kind), sprops))
    # the full-size views
    view = cv2.imread(p(TIMING))
    save("timing_superres_1297x840.avif", oracle.encoded_avif(
        yuv_planes(view, 6), 8, 1, 1, superres=(1, 12, 12),
        controls={"enable-restoration": 1, "cq-level": 28}))
    save("timing_deltalf_1297x840.avif", oracle.encoded_avif(
        yuv_planes(view, 6), 8, 1, 1, controls={
            "deltaq-mode": 3, "deltalf-mode": 1, "cq-level": 28}))
    save("timing_ycgco_1297x840.avif", oracle.encoded_avif(
        yuv_planes(view, 8), 8, 1, 1, controls={"cq-level": 28},
        colr=oracle.nclx(1, 13, 8, True)))
    save("timing_scaled_1297x840.avif", with_ispe(oracle.cv2_avif(
        cv2.resize(view, (1040, 672), interpolation=cv2.INTER_AREA)),
        1297, 840))
    shas = {}
    for name in LIBAVIF_TIMING:
        dec = np.ascontiguousarray(cv2.imread(p(name))[..., ::-1])
        shas[name] = hashlib.sha256(dec.tobytes()).hexdigest()
    if mid_scene is not None:
        src = os.path.join(mid_scene, "images_4")
        os.makedirs(p(AVIF_MID_LIBAVIF), exist_ok=True)
        for k, name in enumerate(sorted(os.listdir(src))):
            save(os.path.join(AVIF_MID_LIBAVIF, name[:-4] + ".avif"),
                 libavif_mid_file(cv2.imread(os.path.join(src, name)), k))
    return shas


# ---------------------------------- AV1 frames after the first (inter)


def translated(img: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """img moved by dy rows and dx columns, its edges repeated."""
    h, w = img.shape[:2]
    pad = ((abs(dy), abs(dy)), (abs(dx), abs(dx))) + ((0, 0),) * (
        img.ndim - 2)
    big = np.pad(img, pad, mode="edge")
    return big[abs(dy) - dy:abs(dy) - dy + h, abs(dx) - dx:abs(dx) - dx + w]


def inter_planes(img: np.ndarray, depth: int, fmt: str) -> list:
    """[Y, U, V] of a BGR image's channels at depth bits (chroma taken
    every other sample where subsampled; 4:0:0: [Y])."""
    a = img.astype(np.int64) << (depth - 8)
    if fmt == "400":
        return [a[..., 0]]
    sx, sy = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}[fmt]
    return [a[..., 0], a[::1 + sy, ::1 + sx, 1], a[::1 + sy, ::1 + sx, 2]]


def inter_frames(img: np.ndarray, n: int, dy: int, dx: int) -> list:
    """n BGR frames of img, each moved by (dy, dx) from the one before; the
    last one's second quarter of rows and columns darkened by a quarter."""
    out = [translated(img, dy * (n - 1 - k), dx * (n - 1 - k))
           for k in range(n)]
    h, w = img.shape[:2]
    last = out[-1].copy()
    last[h // 4:h // 2, w // 4:w // 2] = \
        last[h // 4:h // 2, w // 4:w // 2] * 3 // 4
    out[-1] = last
    return out


def warped_frames(img: np.ndarray, n: int, angle: float, zoom: float,
                  dy: float = 0.0, dx: float = 0.0) -> list:
    """n BGR frames of img, each rotated by ``angle`` degrees, scaled by
    ``zoom`` and moved by (dy, dx) about the centre from the one before
    (the last is img; bilinear, edges clamped): global motion above a
    translation between frames."""
    h, w = img.shape[:2]
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    cy, cx = (h - 1) / 2, (w - 1) / 2
    out = []
    for k in range(n):
        t = n - 1 - k
        a, z = np.deg2rad(angle * t), zoom ** t
        u = ((xx - cx) * np.cos(a) - (yy - cy) * np.sin(a)) / z + cx - dx * t
        v = ((xx - cx) * np.sin(a) + (yy - cy) * np.cos(a)) / z + cy - dy * t
        u, v = np.clip(u, 0, w - 1), np.clip(v, 0, h - 1)
        x0, y0 = np.floor(u).astype(int), np.floor(v).astype(int)
        x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
        fu, fv = (u - x0)[..., None], (v - y0)[..., None]
        f = img.astype(np.float64)
        top = f[y0, x0] * (1 - fu) + f[y0, x1] * fu
        bot = f[y1, x0] * (1 - fu) + f[y1, x1] * fu
        out.append(np.clip(np.round(top * (1 - fv) + bot * fv), 0,
                           255).astype(np.uint8))
    return out


def inter_item(frames, depth: int, fmt: str, **kw) -> bytes:
    """libaom_encode_frames' stream of BGR frames as a one-item AVIF."""
    import torch_avif_oracles as oracle

    sx, sy = {"420": (1, 1), "422": (1, 0), "444": (0, 0),
              "400": (1, 1)}[fmt]
    h, w = frames[0].shape[:2]
    stream = oracle.libaom_encode_frames(
        [inter_planes(f, depth, fmt) for f in frames], depth, sx, sy,
        mono=fmt == "400", **kw)
    return inter_avif(stream, w, h, depth, fmt)


def inter_avif(stream: bytes, w: int, h: int, depth: int, fmt: str
               ) -> bytes:
    import torch_avif_oracles as oracle

    sx, sy = {"420": (1, 1), "422": (1, 0), "444": (0, 0),
              "400": (1, 1)}[fmt]
    mono = fmt == "400"
    props = {b"ispe": oracle.ispe_box(w, h),
             b"pixi": oracle.pixi_box(depth, 1 if mono else 3),
             b"av1C": oracle.av1c_box(depth, sx, sy, mono),
             b"colr": oracle.nclx(1, 13, 6, True)}
    return oracle.build_avif(stream, props)


def inter_mid_shift(k: int):
    return (k % 5) - 2, 3 - (k % 7)


def inter_view(bgr: np.ndarray, dy: int, dx: int, **controls) -> bytes:
    """A key frame of a view translated by (dy, dx), then an inter frame of
    the view (BT.601 full-range 4:2:0, libaom's good-quality encoder, the
    next slice's inter tools off)."""
    import torch_avif_oracles as oracle

    stream = oracle.libaom_encode_frames(
        [yuv_planes(f, 6) for f in (translated(bgr, dy, dx), bgr)], 8, 1, 1,
        controls={**oracle.INTER_TOOLS_OFF, **controls})
    return inter_avif(stream, bgr.shape[1], bgr.shape[0], 8, "420")


def inter_mid_file(bgr: np.ndarray, k: int) -> bytes:
    """View k of AVIF_MID_INTER: inter_view at inter_mid_shift(k)."""
    return inter_view(bgr, *inter_mid_shift(k), **{"cpu-used": 6,
                                                   "cq-level": 20})


def generate_inter(folder: str = FOLDER, mid_scene: str | None = None
                   ) -> dict:
    """The inter slice's fixtures: AVIF_INTER_CASES (but avif_intra_only.avif
    and avif_hidden_key.avif, which generate_libavif writes; the
    avif_unported_*.avif files the port refused then, each found by a
    search for the first file cv2 read and the port refused naming its
    tool, stay as committed: the port reads every one now), the
    TIMING_INTER view (and, given the folder of make_synth_scene --preset
    mid, AVIF_MID_INTER's views); returns the SHA-256 of cv2's decode of
    TIMING_INTER."""
    import hashlib

    import cv2

    import torch_avif_oracles as oracle
    from gsplat_tpu_torch.utils import image_io

    p = lambda name: os.path.join(folder, name)       # noqa: E731

    def save(name, data):
        with open(p(name), "wb") as f:
            f.write(data)
    off = oracle.INTER_TOOLS_OFF
    rng = np.random.default_rng(47)
    sizes = {"420": (72, 100), "422": (64, 96), "444": (56, 88),
             "400": (80, 104)}
    for depth in (8, 10, 12):
        for fmt in ("420", "422", "444", "400"):
            if fmt == "400" and depth == 12:
                continue
            h, w = sizes[fmt]
            img = oracle.avif_image("photo", h, w, rng)
            n = 2 + (depth // 2) % 3
            save(f"avif_inter_d{depth}_{fmt}.avif", inter_item(
                inter_frames(img, n, 2, -3), depth, fmt, controls={
                    **off, "cpu-used": 4, "cq-level": 28}))
    img = oracle.avif_image("photo", 136, 300, rng)
    save("avif_inter_sb128_tiles.avif", inter_item(
        inter_frames(img, 3, -2, 4), 8, "420", controls={
            **off, "cpu-used": 4, "superblock-size": 1, "tile-columns": 1,
            "tile-rows": 1}))
    # loop restoration in an inter frame: libaom searches it at speed 0
    for seed in range(20):
        img = oracle.avif_image("photo", 200, 300,
                                np.random.default_rng(seed))
        data = inter_item(inter_frames(img, 2, 1, 2), 8, "420", controls={
            **off, "cpu-used": 0, "enable-restoration": 1, "cq-level": 30})
        heif = image_io._Heif(data, "lr")
        heif.parse()
        info = image_io.decode_av1(heif.primary_item()[0])[1]
        if info[29] + info[30] > 0 and info[13]:
            save("avif_inter_cdef_lr.avif", data)
            break
    else:
        raise SystemExit("no inter frame of 20 uses loop restoration")
    img = oracle.avif_image("photo", 128, 160, rng)
    save("avif_inter_seg_temporal.avif", inter_item(
        inter_frames(img, 4, 2, -3), 8, "420", controls={
            **off, "cpu-used": 6, "aq-mode": 3}))
    img = oracle.avif_image("photo", 80, 120, rng)
    save("avif_inter_grain_ref.avif", inter_item(
        inter_frames(img, 3, 1, -1), 8, "420", controls={
            **off, "cpu-used": 6, "film-grain-test-vector": 5}))
    img = oracle.avif_image("photo", 256, 256, rng)
    save("avif_inter_switchable.avif", inter_item(
        inter_frames(img, 3, 3, -5), 8, "420", controls={
            **off, "cpu-used": 0, "cq-level": 20}))
    img = oracle.avif_image("photo", 72, 100, rng)
    stream = oracle.libaom_encode_frames(
        [inter_planes(f, 8, "420") for f in inter_frames(img, 3, -2, 2)], 8,
        1, 1, controls={**off, "cpu-used": 5})
    save("avif_inter_hidden.avif", inter_avif(
        oracle.hide_last_frame(stream), 100, 72, 8, "420"))
    view = cv2.imread(p(TIMING))
    save(TIMING_INTER, inter_view(view, *TIMING_INTER_SHIFT, **{
        "cpu-used": 3, "cq-level": 28}))
    dec = np.ascontiguousarray(cv2.imread(p(TIMING_INTER))[..., ::-1])
    if mid_scene is not None:
        src = os.path.join(mid_scene, "images_4")
        os.makedirs(p(AVIF_MID_INTER), exist_ok=True)
        for k, name in enumerate(sorted(os.listdir(src))):
            save(os.path.join(AVIF_MID_INTER, name[:-4] + ".avif"),
                 inter_mid_file(cv2.imread(os.path.join(src, name)), k))
    return {TIMING_INTER: hashlib.sha256(dec.tobytes()).hexdigest()}


def tools_info(data: bytes) -> list:
    """decode_av1's counters of an item's inter tools (info[58:67]): frames
    with motion-field projection, blocks with a temporal candidate,
    LOCALWARP blocks and invalid ones, references with global motion,
    warped GLOBALMV blocks, OBMC blocks, inter-intra blocks (smooth,
    wedge); then the frames decoded."""
    from gsplat_tpu_torch.utils import image_io

    heif = image_io._Heif(data, "tools")
    heif.parse()
    info = image_io.decode_av1(heif.primary_item()[0])[1]
    return info[58:67] + [info[46]]


def find_fixture(path: str, make, uses, tries: int = 200):
    """Writes to path the first of make(rng) over seeds 0.. (None: passed
    over) that cv2 reads as the port does and of which uses(data) holds."""
    import cv2

    from gsplat_tpu_torch.utils.image_io import read_avif

    with tempfile.TemporaryDirectory() as tmp:
        probe = os.path.join(tmp, "probe.avif")
        for seed in range(tries):
            data = make(np.random.default_rng(seed))
            if data is None:
                continue
            with open(probe, "wb") as f:
                f.write(data)
            want = cv2.imread(probe)
            try:
                got = read_avif(probe)
            except RuntimeError:
                continue
            if want is not None and (got == want[..., ::-1]).all() \
                    and uses(data):
                with open(path, "wb") as f:
                    f.write(data)
                return seed
    raise SystemExit(f"no file of {tries} makes {os.path.basename(path)}")


def tools_mid_file(bgr: np.ndarray, k: int) -> bytes:
    """View k of AVIF_MID_DEFAULT: libaom at its default inter tools on the
    view translated twice by inter_mid_shift(k), once, then the view."""
    import torch_avif_oracles as oracle

    dy, dx = inter_mid_shift(k)
    stream = oracle.libaom_encode_frames(
        [yuv_planes(translated(bgr, dy * t, dx * t), 6) for t in (2, 1, 0)],
        8, 1, 1, controls={"cpu-used": 6, "cq-level": 20})
    return inter_avif(stream, bgr.shape[1], bgr.shape[0], 8, "420")


def generate_inter_tools(folder: str = FOLDER, mid_scene: str | None = None
                         ) -> dict:
    """The inter tools' fixtures: AVIF_TOOLS_CASES but the moved files
    (each a seeded search for the first file that cv2 reads as the port
    does and that uses what the file is for), the TIMING_TOOLS view (and,
    given the folder of make_synth_scene --preset mid, AVIF_MID_DEFAULT's
    views); returns the SHA-256 of cv2's decode of TIMING_TOOLS."""
    import hashlib

    import cv2

    import torch_avif_oracles as oracle

    p = lambda name: os.path.join(folder, name)       # noqa: E731
    # compound prediction's controls, off in every file here: libaom's
    # files that use it, or skip mode, are passed over
    no_compound = dict.fromkeys(oracle.COMPOUND_TOOLS, 0)

    def find(name, make, uses, tries=200):
        find_fixture(os.path.join(folder, name), make,
                     lambda data: uses(tools_info(data)), tries)

    def frames(r, n, warped=False, kind=None):
        h, w = int(r.integers(56, 120)), int(r.integers(64, 160))
        img = oracle.avif_image(kind or str(r.choice(["photo", "smooth",
                                                      "noise"])), h, w, r)
        if warped:
            return warped_frames(img, n, float(r.uniform(-8, 8)),
                                 float(r.uniform(0.9, 1.1)),
                                 float(r.uniform(-3, 3)),
                                 float(r.uniform(-3, 3)))
        return inter_frames(img, n, int(r.integers(-4, 5)),
                            int(r.integers(-4, 5)))

    for i, (depth, fmt) in enumerate(AVIF_TOOLS_FORMATS):
        ctl = {**no_compound, "cpu-used": i % 7, "cq-level": 12 + 4 * i}
        find(f"avif_tools_d{depth}_{fmt}.avif", lambda r: inter_item(
            frames(r, 4, warped=i % 3 == 2, kind="photo"), depth, fmt,
            controls=ctl), lambda t: t[0] > 0 and t[1] > 0)
    find("avif_tools_sb128_tiles.avif", lambda r: inter_item(
        inter_frames(oracle.avif_image("photo", 136, 296, r), 4,
                     int(r.integers(-4, 5)), int(r.integers(-4, 5))), 8,
        "420", controls={**no_compound, "cpu-used": 3, "superblock-size": 1,
                         "tile-columns": 1, "tile-rows": 1}),
        lambda t: t[0] > 0 and t[1] > 0)
    find("avif_tools_grain.avif", lambda r: inter_item(
        frames(r, 4, kind="photo"), 10, "420", controls={
            **no_compound, "cpu-used": 4, "film-grain-test-vector": 3}),
        lambda t: t[0] > 0 and t[1] > 0)
    for tool, ctl in AVIF_TOOLS_ALONE.items():
        on = {ctl: 1}
        if tool.startswith("interintra"):
            on["enable-interintra-comp"] = 1
        find(f"avif_tool_{tool}.avif", lambda r: inter_item(
            frames(r, int(r.integers(3, 5)), warped=tool == "global"), 8,
            "420", controls={**oracle.INTER_TOOLS_OFF, **on,
                             "cpu-used": int(r.integers(0, 5)),
                             "cq-level": int(r.integers(10, 50))}),
            lambda t: t[AVIF_TOOLS_COUNTER[tool]] > 0)
    find("avif_tools_rotzoom.avif", lambda r: inter_item(
        frames(r, 4, warped=True), 8, "420", controls={
            **no_compound, "cpu-used": int(r.integers(0, 5)),
            "cq-level": int(r.integers(10, 40))}),
        lambda t: t[4] > 0 and t[5] > 0 and t[2] > 0)

    def flipped(r, name="avif_tools_d8_444.avif"):
        with open(p(name), "rb") as f:
            obu, props = oracle.item_parts(f.read())
        data = bytearray(obu)
        data[int(r.integers(len(data) // 3, len(data)))] ^= \
            1 << int(r.integers(8))
        return oracle.build_avif(bytes(data), props)
    find("avif_tools_invalid_warp.avif", flipped, lambda t: t[3] > 0,
         tries=20000)
    view = cv2.imread(p(TIMING))
    dy, dx = TIMING_INTER_SHIFT
    stream = oracle.libaom_encode_frames(
        [yuv_planes(translated(view, dy * t, dx * t), 6)
         for t in (3, 2, 1, 0)], 8, 1, 1,
        controls={"cpu-used": 3, "cq-level": 28})
    with open(p(TIMING_TOOLS), "wb") as f:
        f.write(inter_avif(stream, view.shape[1], view.shape[0], 8, "420"))
    dec = np.ascontiguousarray(cv2.imread(p(TIMING_TOOLS))[..., ::-1])
    if mid_scene is not None:
        src = os.path.join(mid_scene, "images_4")
        os.makedirs(p(AVIF_MID_DEFAULT), exist_ok=True)
        for k, name in enumerate(sorted(os.listdir(src))):
            with open(p(os.path.join(AVIF_MID_DEFAULT, name[:-4] + ".avif")),
                      "wb") as f:
                f.write(tools_mid_file(cv2.imread(os.path.join(src, name)),
                                       k))
    return {TIMING_TOOLS: hashlib.sha256(dec.tobytes()).hexdigest()}


def compound_info(data: bytes) -> list:
    """decode_av1's counters of compound prediction (info[67:73]): compound
    blocks by type (average, distance weights, wedge, difference-weighted),
    skip-mode blocks, single-reference blocks beside a compound neighbour;
    then the frames decoded."""
    from gsplat_tpu_torch.utils import image_io

    heif = image_io._Heif(data, "compound")
    heif.parse()
    info = image_io.decode_av1(heif.primary_item()[0])[1]
    return info[67:73] + [info[46]]


def temporal_units(data: bytes) -> list:
    """A one-item file cut after each of its temporal units: the files of
    its first 1, 2, ... units (cv2 shows the last frame shown of each, so
    every shown frame is seen in one of them)."""
    import torch_avif_oracles as oracle

    obu, props = oracle.item_parts(data)
    ob = oracle.obus(obu)
    ends = [i for i, (kind, _, _) in enumerate(ob) if kind == 2][1:] + \
        [len(ob)]
    return [oracle.build_avif(b"".join(
        head + oracle._leb(len(pay)) + pay for _, head, pay in ob[:e]),
        props) for e in ends]


def compound_prefix(data: bytes, uses, info_of=None):
    """The file cut after the first temporal unit that decodes one frame
    whose own compound_info (or ``info_of``'s counts, the frames decoded
    last; the counts of that frame alone) satisfies uses: the last frame
    shown is then the one that uses the tool; None where no unit does."""
    prev = None
    for item in temporal_units(data):
        info = (info_of or compound_info)(item)
        if prev is not None:
            own = [a - b for a, b in zip(info, prev)]
            if own[-1] == 1 and uses(own):
                return item
        prev = info
    return None


def compound_item(r, depth: int, fmt: str, *, lag: int = 0,
                  controls=None, size=None) -> bytes:
    """An item of libaom at every default where it takes compound
    prediction: a photo crop of 64-159 x 64-199 (or ``size``), 3-6 frames
    each moved by up to 4 pixels from the one before (inter_frames), speed
    0-2, a quantizer of 10-49, ``controls`` over those, ``lag`` frames of
    lookahead."""
    import torch_avif_oracles as oracle

    h, w = int(r.integers(64, 160)), int(r.integers(64, 200))
    if size is not None:
        h, w = size
    img = oracle.avif_image("photo", h, w, r)
    frames = inter_frames(img, int(r.integers(3, 7)), int(r.integers(-4, 5)),
                          int(r.integers(-4, 5)))
    ctl = {"cpu-used": int(r.integers(0, 3)),
           "cq-level": int(r.integers(10, 50)), **(controls or {})}
    return inter_item(frames, depth, fmt, controls=ctl, lag=lag)


def noisy_frames(bgr: np.ndarray, n: int, dy: int, dx: int, rng,
                 sigma: float = COMPOUND_NOISE) -> list:
    """n frames of a view, each moved by (dy, dx) from the one before, the
    last the view itself; each but the last with Gaussian noise of sigma
    (a capture's sensor noise, which averaging two references takes out:
    libaom's encoder then takes compound prediction)."""
    out = []
    for t in range(n - 1, -1, -1):
        f = translated(bgr, dy * t, dx * t)
        if t:
            f = np.clip(np.round(f + rng.normal(0.0, sigma, f.shape)), 0,
                        255).astype(np.uint8)
        out.append(f)
    return out


def compound_view(frames) -> bytes:
    """libaom at every default on BGR frames (BT.601 full-range 4:2:0,
    COMPOUND_SPEED, COMPOUND_CQ, no lookahead: the last frame shown predicts
    from the frames before it)."""
    import torch_avif_oracles as oracle

    h, w = frames[0].shape[:2]
    stream = oracle.libaom_encode_frames(
        [yuv_planes(f, 6) for f in frames], 8, 1, 1, controls={
            "cpu-used": COMPOUND_SPEED, "cq-level": COMPOUND_CQ})
    return inter_avif(stream, w, h, 8, "420")


def compound_mid_file(bgr: np.ndarray, k: int) -> bytes:
    """View k of AVIF_MID_COMPOUND: compound_view of noisy_frames of the view
    moved by inter_mid_shift(k), the noise seeded by k."""
    return compound_view(noisy_frames(bgr, COMPOUND_MID_FRAMES,
                                      *inter_mid_shift(k),
                                      np.random.default_rng(k)))


def _compound_mid_job(args):
    path, k, out = args
    import cv2

    with open(out, "wb") as f:
        f.write(compound_mid_file(cv2.imread(path), k))


def generate_compound(folder: str = FOLDER, mid_scene: str | None = None
                      ) -> dict:
    """Compound prediction's fixtures: AVIF_COMPOUND_CASES but the moved
    files (each a seeded search, find_fixture, over compound_item), the
    TIMING_COMPOUND view (and, given the folder of make_synth_scene --preset
    mid, AVIF_MID_COMPOUND's views, four processes at a time); returns the
    SHA-256 of cv2's decode of TIMING_COMPOUND."""
    import hashlib
    import multiprocessing

    import cv2

    import torch_avif_oracles as oracle

    p = lambda name: os.path.join(folder, name)       # noqa: E731

    def find(name, make, uses):
        find_fixture(p(name), lambda r: compound_prefix(make(r), uses),
                     lambda data: True)

    def any_compound(t):
        return sum(t[:4]) > 0
    for i, (depth, fmt) in enumerate(AVIF_TOOLS_FORMATS):
        find(f"avif_compound_d{depth}_{fmt}.avif", lambda r: compound_item(
            r, depth, fmt, lag=35 * (i % 2)), any_compound)
    for tool, (on, lag, counter) in AVIF_COMPOUND_ALONE.items():
        find(f"avif_compound_{tool}.avif", lambda r: compound_item(
            r, 8, "420", lag=lag, controls={**oracle.INTER_TOOLS_OFF, **on}),
            lambda t: t[counter] > 0)
    find("avif_compound_skip_mode.avif", lambda r: compound_item(
        r, 10, "420", lag=35), lambda t: t[4] > 0)
    find("avif_compound_neighbours.avif", lambda r: compound_item(
        r, 8, "444"), lambda t: t[5] > 0 and any_compound(t))
    view = cv2.imread(p(TIMING))
    find_fixture(p(TIMING_COMPOUND), lambda r: compound_view(noisy_frames(
        view, COMPOUND_MID_FRAMES, *TIMING_INTER_SHIFT, r)),
        lambda data: any_compound(compound_info(data)) and
        compound_info(data)[4] > 0)
    dec = np.ascontiguousarray(cv2.imread(p(TIMING_COMPOUND))[..., ::-1])
    if mid_scene is not None:
        src = os.path.join(mid_scene, "images_4")
        os.makedirs(p(AVIF_MID_COMPOUND), exist_ok=True)
        jobs = [(os.path.join(src, name), k,
                 p(os.path.join(AVIF_MID_COMPOUND, name[:-4] + ".avif")))
                for k, name in enumerate(sorted(os.listdir(src)))]
        with multiprocessing.get_context("spawn").Pool(4) as pool:
            pool.map(_compound_mid_job, jobs)
    return {TIMING_COMPOUND: hashlib.sha256(dec.tobytes()).hexdigest()}


def scaled_info(data: bytes) -> list:
    """decode_av1's counters of references of another size (info[73:80]):
    blocks predicted from a scaled reference, inter frames coded with
    superres, switch frames, blocks whose warp a scaled reference turned
    into a translation, inter frames that name a reference coded with
    superres, compound blocks with a scaled reference, OBMC blocks that
    predicted from one; then the frames decoded."""
    from gsplat_tpu_torch.utils import image_io

    heif = image_io._Heif(data, "scaled")
    heif.parse()
    info = image_io.decode_av1(heif.primary_item()[0])[1]
    return info[73:80] + [info[46]]


def scaled_item(r, depth: int, fmt: str, *, controls=None, **kw) -> bytes:
    """An item of libaom's good-quality encoder with ``resize`` or
    ``superres`` (kw): a photo crop of 64-143 x 64-175, 3-5 frames each
    moved by up to 4 pixels from the one before (inter_frames), speed 3-5,
    a quantizer of 10-49, ``controls`` over those."""
    import torch_avif_oracles as oracle

    h, w = int(r.integers(64, 144)), int(r.integers(64, 176))
    img = oracle.avif_image("photo", h, w, r)
    seq = inter_frames(img, int(r.integers(3, 6)), int(r.integers(-4, 5)),
                       int(r.integers(-4, 5)))
    ctl = {"cpu-used": int(r.integers(3, 6)),
           "cq-level": int(r.integers(10, 50)), **(controls or {})}
    return inter_item(seq, depth, fmt, controls=ctl, **kw)


def scaled_view(frames, **kw) -> bytes:
    """libaom's good-quality encoder at its default tools on BGR frames
    (BT.601 full-range 4:2:0, speed 6, cq 20) with ``resize`` or
    ``superres`` (kw)."""
    import torch_avif_oracles as oracle

    h, w = frames[0].shape[:2]
    stream = oracle.libaom_encode_frames(
        [yuv_planes(f, 6) for f in frames], 8, 1, 1,
        controls={"cpu-used": 6, "cq-level": 20}, **kw)
    return inter_avif(stream, w, h, 8, "420")


def scaled_mid_file(bgr: np.ndarray, k: int) -> bytes:
    """View k of AVIF_MID_SCALED: scaled_view of the view translated twice
    by inter_mid_shift(k), once, then the view, resized (even k) or with
    superres (odd k) at 8/d, d = 9 + k // 2 % 8."""
    dy, dx = inter_mid_shift(k)
    d = 9 + k // 2 % 8
    kw = {"superres": (1, d, 8)} if k % 2 else {"resize": (1, d, 8)}
    return scaled_view([translated(bgr, dy * t, dx * t)
                        for t in (2, 1, 0)], **kw)


def _scaled_mid_job(args):
    path, k, out = args
    import cv2

    with open(out, "wb") as f:
        f.write(scaled_mid_file(cv2.imread(path), k))


def generate_scaled(folder: str = FOLDER, mid_scene: str | None = None
                    ) -> dict:
    """The fixtures of references of another size and of switch frames:
    AVIF_SCALED_CASES but the moved files (each a seeded search,
    find_fixture, over scaled_item, cut after the first frame that uses
    its kind), AVIF_SCALED_REFUSED, avif_unported_ref_order_hint.avif (of
    AVIF_REBUILT_CASES), the TIMING_RESIZE
    view (and, given the folder of make_synth_scene --preset mid,
    AVIF_MID_SCALED's views, four processes at a time); returns the SHA-256
    of cv2's decode of TIMING_RESIZE."""
    import hashlib
    import multiprocessing

    import cv2

    import torch_avif_oracles as oracle

    p = lambda name: os.path.join(folder, name)       # noqa: E731

    def find(name, make, uses):
        find_fixture(p(name), lambda r: compound_prefix(
            make(r), uses, scaled_info), lambda data: True)

    for i, (depth, fmt) in enumerate(AVIF_TOOLS_FORMATS):
        d = 16 if i % 2 else 9
        find(f"avif_resize_d{depth}_{fmt}.avif", lambda r: scaled_item(
            r, depth, fmt, resize=(1, d, 8)), lambda t: t[0] > 0)
    formats = iter(AVIF_TOOLS_FORMATS[::2])
    for kind, sr in AVIF_SUPERRES_KINDS.items():
        for d in (9, 16):
            depth, fmt = next(formats)
            # superres of the key frame alone: its inter frames name a
            # reference coded with superres, at its own upscaled size
            uses = (lambda t: t[4] > 0) if kind == "key" else \
                (lambda t: t[0] > 0 and t[1] > 0)
            find(f"avif_superres_{kind}_{d}.avif", lambda r: scaled_item(
                r, depth, fmt, superres=sr(d)), uses)
    # compound prediction (libaom takes it at speeds 0-2, and beside a
    # scaled reference with its lookahead's backward references), OBMC
    find("avif_scaled_compound.avif", lambda r: scaled_item(
        r, 8, "420", controls={"cpu-used": int(r.integers(0, 3))},
        resize=(1, int(r.integers(9, 17)), 8), lag=35), lambda t: t[5] > 0)
    find("avif_scaled_obmc.avif", lambda r: scaled_item(
        r, 10, "444", controls={**oracle.INTER_TOOLS_OFF, "enable-obmc": 1},
        resize=(1, int(r.integers(9, 17)), 8)), lambda t: t[6] > 0)
    # libaom codes no global motion in a frame of another size (none in
    # resize's or superres' files), so the global file is avif_tool_global's
    # first three frames with the third's width one sample less (the same mi
    # grid: the tile data decodes as before, every reference now scaled);
    # and a frame one sample wider than the sequence's maximum, which libaom
    # reads where the size is not a reference's (setup_frame_size_with_refs
    # holds no maximum)
    for name, src, unit, dw in (
            ("avif_scaled_global.avif", "avif_tool_global.avif", 2, -1),
            ("avif_scaled_over_max.avif", "avif_unported_global.avif", 1,
             1)):
        with open(p(src), "rb") as f:
            obu, props = oracle.item_parts(temporal_units(f.read())[unit])
        w, h = struct.unpack_from(">II", props[b"ispe"], 12)
        data = oracle.build_avif(oracle.with_frame_size(obu, w + dw, h),
                                 props)
        with open(p(name), "wb") as f:
            f.write(data)
    # a reference more than twice the frame: libaom's resize to half the
    # key frame's width, the last frame's width one sample less
    img = oracle.avif_image("photo", 72, 100, np.random.default_rng(26))
    stream = oracle.libaom_encode_frames(
        [inter_planes(f, 8, "420") for f in inter_frames(img, 4, 2, -3)],
        8, 1, 1, resize=(1, 16, 8), controls={
            "cpu-used": 4, "error-resilient-mode": 1})
    with open(p("avif_ref_too_large.avif"), "wb") as f:
        f.write(inter_avif(oracle.with_frame_size(stream, 49, 36), 100, 72,
                           8, "420"))
    # a slot's ref_order_hint rewritten: the LAST frame's slot
    order, idx = oracle.ref_order_hints(stream)
    with open(p("avif_unported_ref_order_hint.avif"), "wb") as f:
        f.write(inter_avif(oracle.with_ref_order_hint(
            stream, idx[0], order[idx[0]] + 1), 100, 72, 8, "420"))
    view = cv2.imread(p(TIMING))
    find_fixture(p(TIMING_RESIZE), lambda r: scaled_view(
        [translated(view, TIMING_INTER_SHIFT[0] * t,
                    TIMING_INTER_SHIFT[1] * t) for t in (3, 2, 1, 0)],
        resize=(1, 12, 8)), lambda data: scaled_info(data)[0] > 0, tries=1)
    dec = np.ascontiguousarray(cv2.imread(p(TIMING_RESIZE))[..., ::-1])
    if mid_scene is not None:
        src = os.path.join(mid_scene, "images_4")
        os.makedirs(p(AVIF_MID_SCALED), exist_ok=True)
        jobs = [(os.path.join(src, name), k,
                 p(os.path.join(AVIF_MID_SCALED, name[:-4] + ".avif")))
                for k, name in enumerate(sorted(os.listdir(src)))]
        with multiprocessing.get_context("spawn").Pool(4) as pool:
            pool.map(_scaled_mid_job, jobs)
    return {TIMING_RESIZE: hashlib.sha256(dec.tobytes()).hexdigest()}



# ------------------------------------------- reference slots rebuilt

def rebuilt_info(data: bytes) -> list:
    """decode_av1's counters of reference slots rebuilt from ref_order_hint
    (info[80:84]): slots rebuilt, inter frames that name one, blocks
    predicted from one, reads of what a rebuilt buffer kept of its last
    frame; then the frames decoded."""
    from gsplat_tpu_torch.utils import image_io

    heif = image_io._Heif(data, "rebuilt")
    heif.parse()
    info = image_io.decode_av1(heif.primary_item()[0])[1]
    return info[80:84] + [info[46]]


def _frame_refs(stream: bytes) -> list:
    """torch_avif_oracles.frame_refs of each frame OBU (None: an intra
    frame)."""
    import torch_avif_oracles as oracle

    out = []
    for k in range(sum(1 for t, _, _ in oracle.obus(stream) if t == 6)):
        try:
            out.append(oracle.frame_refs(stream, k))
        except AssertionError:
            out.append(None)
    return out


def rebuilt_stream(stream: bytes, kind: str, r, wrap, score=None):
    """libaom's stream with a slot's ref_order_hint rewritten (a hint 1-64
    past the slot's), of ``kind``: "named", the last frame's, a slot its
    references name (the first of them that a block predicts from after
    the rewrite); "unnamed", the last frame's, a slot they do not name;
    "leftover", an error resilient frame's, a slot a later frame without
    error resilience names and no frame between refreshes, the first such
    whose rebuilt buffer the later frame reads through its primary
    reference frame or a motion-field projection (rebuilt_info[3] > 0:
    the buffer held a decoded frame before). ``wrap`` makes a file of a
    stream (for rebuilt_info); with ``score`` (of the file) the slot of the
    highest score is taken, not the first. None where no slot does."""
    import torch_avif_oracles as oracle

    refs = _frame_refs(stream)
    last = len(refs) - 1
    if kind == "leftover":
        options = []
        for k, fk in enumerate(refs):
            if not fk or not fk["resilient"]:
                continue
            for j in range(k + 1, len(refs)):
                if not refs[j] or refs[j]["resilient"]:
                    continue
                for slot in sorted(set(refs[j]["idx"])):
                    if not any(refs[m] is None or (refs[m]["refresh"] >> slot)
                               & 1 for m in range(k, j)):
                        options.append((k, slot))
    else:
        if not refs[last] or not refs[last]["resilient"]:
            return None
        named = refs[last]["idx"]
        slots = list(dict.fromkeys(named)) if kind == "named" else \
            [i for i in range(8) if i not in named]
        options = [(last, slot) for slot in slots]
    best = None
    for k, slot in dict.fromkeys(options):
        order, _ = oracle.ref_order_hints(stream, k)
        out = oracle.with_ref_order_hint(stream, slot, order[slot] + int(
            r.integers(1, 65)), k)
        try:
            got = rebuilt_info(wrap(out))
        except RuntimeError:           # refused: a fresh buffer's state
            continue
        if kind == "unnamed" or got[3 if kind == "leftover" else 2] > 0:
            if score is None:
                return out
            got = score(wrap(out))
            if best is None or got > best[0]:
                best = (got, out)
    return None if best is None else best[1]


def rebuilt_shown(stream: bytes, r, showable: bool, wrap):
    """libaom's stream (no frame ids) with a slot's ref_order_hint
    rewritten in an error resilient frame, a slot no later frame refreshes,
    and a show_existing_frame header of that slot after the last frame:
    the first such whose rebuilt buffer held a decoded, showable frame
    (libaom shows the neutral-grey buffer, with the film grain it kept), or
    with ``showable`` False one that did not (libaom refuses the file);
    ``wrap`` makes a file of a stream. None where no slot does."""
    import torch_avif_oracles as oracle

    refs = _frame_refs(stream)
    for k, fk in enumerate(refs):
        if not fk or not fk["resilient"]:
            continue
        for slot in range(8):
            if any(refs[m] is None or (refs[m]["refresh"] >> slot) & 1
                   for m in range(k, len(refs))):
                continue
            order, _ = oracle.ref_order_hints(stream, k)
            out = oracle.with_ref_order_hint(stream, slot, order[slot] + int(
                r.integers(1, 65)), k)
            try:
                rebuilt_info(wrap(out))     # the frames decode
            except RuntimeError:
                continue
            out += oracle.obu(3, oracle._bytes("1" + format(slot, "03b") +
                                               "1"))
            try:
                rebuilt_info(wrap(out))
            except RuntimeError:
                if not showable:
                    return out
                continue
            if showable:
                return out
    return None


# an error resilient frame, and the same frame without its last-frame,
# golden and altref refreshes (then a later frame's LAST can be a slot it
# rebuilt)
REBUILT_FLAGS = {"leftover": {3: 1 << 28, 5: (1 << 28) | (7 << 23)}}


def rebuilt_item(r, depth: int, fmt: str, kind: str):
    """A one-item AVIF of libaom's good-quality encoder at its default
    tools (speed 4-6, a quantizer of 10-49) on a photo crop of 48-111 x
    48-143, frames each moved by up to 3 pixels from the one
    before (inter_frames), with a slot rebuilt (rebuilt_stream): "named"
    and "unnamed" on 3 frames, each error resilient; "scaled" the same
    with libaom's resize of inter frames to half the key frame's size (the
    rebuilt slot, at the sequence's maximum size, is then a 2x reference);
    "leftover" on 7 frames, error resilient from the fourth to the sixth
    (REBUILT_FLAGS), the others not. None where no slot does."""
    import torch_avif_oracles as oracle

    h, w = int(r.integers(48, 112)), int(r.integers(48, 144))
    img = oracle.avif_image("photo", h, w, r)
    n = 7 if kind == "leftover" else 3
    frames = inter_frames(img, n, int(r.integers(-3, 4)),
                          int(r.integers(-3, 4)))
    ctl = {"cpu-used": int(r.integers(4, 7)),
           "cq-level": int(r.integers(10, 50))}
    kw = {}
    if kind != "leftover":
        ctl["error-resilient-mode"] = 1
    if kind == "scaled":
        kw["resize"] = (1, 16, 8)
    sx, sy = {"420": (1, 1), "422": (1, 0), "444": (0, 0),
              "400": (1, 1)}[fmt]
    stream = oracle.libaom_encode_frames(
        [inter_planes(f, depth, fmt) for f in frames], depth, sx, sy,
        mono=fmt == "400", flags=REBUILT_FLAGS.get(kind), controls=ctl,
        **kw)
    wrap = lambda st: inter_avif(st, w, h, depth, fmt)   # noqa: E731
    out = rebuilt_stream(stream, "named" if kind == "scaled" else kind, r,
                         wrap)
    return None if out is None else wrap(out)


def rebuilt_mid_file(bgr: np.ndarray, k: int) -> bytes:
    """View k of AVIF_MID_REBUILT, of kind REBUILT_KINDS[k % 3]: libaom's
    good-quality encoder (speed 6, cq 20; 8-bit BT.601 full-range 4:2:0)
    on the view translated by inter_mid_shift(k) n - 1 times, ..., once,
    then the view itself (n = 3; 7-10 for "leftover"), every frame error
    resilient ("leftover": REBUILT_FLAGS'), "scaled" with the inter frames
    resized to half (resize (1, 16, 8)); the slot rebuilt of those
    rebuilt_stream takes the one whose decode is nearest the view (PSNR:
    a grey reference mars the blocks that predict from it)."""
    import torch_avif_oracles as oracle
    from gsplat_tpu_torch.utils import image_io

    kind = REBUILT_KINDS[k % 3]
    dy, dx = inter_mid_shift(k)
    h, w = bgr.shape[:2]
    ctl = {"cpu-used": 6, "cq-level": 20}
    if kind != "leftover":
        ctl["error-resilient-mode"] = 1
    wrap = lambda st: inter_avif(st, w, h, 8, "420")     # noqa: E731
    rgb = bgr[..., ::-1].astype(np.float64)

    def nearness(data):                 # PSNR's order: less squared error
        err = image_io._decode_avif_bytes(data, "view") - rgb
        return -float(np.mean(err * err))
    # where no slot of 7 frames is of the kind, 8, 9 or 10 frames
    for n in (3,) if kind != "leftover" else (7, 8, 9, 10):
        stream = oracle.libaom_encode_frames(
            [yuv_planes(translated(bgr, dy * t, dx * t), 6)
             for t in range(n - 1, -1, -1)], 8, 1, 1,
            flags=REBUILT_FLAGS.get(kind), controls=ctl,
            **({"resize": (1, 16, 8)} if kind == "scaled" else {}))
        out = rebuilt_stream(stream, "named" if kind == "scaled" else kind,
                             np.random.default_rng(k), wrap, nearness)
        if out is not None:
            return wrap(out)
    raise AssertionError(f"view {k}: no slot of kind {kind}")


def _rebuilt_mid_job(args):
    path, k, out = args
    import cv2

    with open(out, "wb") as f:
        f.write(rebuilt_mid_file(cv2.imread(path), k))


def generate_rebuilt(folder: str = FOLDER, mid_scene: str | None = None
                     ) -> tuple:
    """The fixtures of reference slots libaom rebuilds from ref_order_hint:
    AVIF_REBUILT_CASES but the moved file (each kind's files a seeded
    search, find_fixture, over rebuilt_item or rebuilt_shown for the first
    that cv2 reads as the port does and that uses its kind),
    AVIF_REBUILT_REFUSED, the TIMING_REBUILT view (and, given the folder
    of make_synth_scene --preset mid, AVIF_MID_REBUILT's views, four
    processes at a time); returns (the SHA-256 of cv2's decode of
    TIMING_REBUILT, those of AVIF_MID_REBUILT's views: {} without the
    scene)."""
    import hashlib
    import multiprocessing

    import cv2

    import torch_avif_oracles as oracle

    p = lambda name: os.path.join(folder, name)       # noqa: E731

    def save(name, data):
        with open(p(name), "wb") as f:
            f.write(data)
    for kind in REBUILT_KINDS:
        for depth, fmt in AVIF_REBUILT_FORMATS:
            name = f"avif_rebuilt_{kind}_d{depth}_{fmt}.avif"
            at = AVIF_REBUILT_COUNTER[name]
            find_fixture(p(name), lambda r: rebuilt_item(
                r, depth, fmt, kind), lambda d: rebuilt_info(d)[at] > 0)
    find_fixture(p("avif_rebuilt_unnamed.avif"), lambda r: rebuilt_item(
        r, 10, "444", "unnamed"), lambda d: rebuilt_info(d)[:3] == [1, 0, 0])
    # eight empty slots: cv2's 12-bit still as an error resilient intra-only
    # frame first
    rng = np.random.default_rng(29)
    img = oracle.deepen(oracle.avif_image("photo", 40, 56, rng), rng) >> 4
    obu, props = oracle.item_parts(oracle.cv2_avif(img, 60, 12))
    empty = oracle.full_headers(obu, still=0, frame_kind="intra_only_"
                                "resilient", hints=(5, 9, 0, 3, 127, 1, 2,
                                                    64))
    save("avif_rebuilt_empty.avif", oracle.build_avif(empty, props))
    # a show_existing_frame of a rebuilt slot: shown (grey, its buffer's
    # grain), and refused where the buffer held no frame
    for name, depth, fmt, grain, showable in (
            ("avif_rebuilt_shown.avif", 10, "444", 0, True),
            ("avif_rebuilt_shown_grain.avif", 8, "420", 1, True),
            ("avif_rebuilt_fresh_shown.avif", 8, "420", 0, False)):
        def make(r):
            img = oracle.avif_image("photo", 56, 72, r)
            sx, sy = {"420": (1, 1), "444": (0, 0)}[fmt]
            ctl = {"cpu-used": 5}
            if grain:
                ctl["film-grain-test-vector"] = 3
            stream = oracle.libaom_encode_frames(
                [inter_planes(f, depth, fmt) for f in inter_frames(
                    img, 7, 1, 2)], depth, sx, sy,
                flags=REBUILT_FLAGS["leftover"], controls=ctl)
            wrap = lambda s: inter_avif(s, 72, 56, depth, fmt)  # noqa
            out = rebuilt_shown(stream, r, showable, wrap)
            return None if out is None else wrap(out)
        if showable:
            find_fixture(p(name), make, lambda d: rebuilt_info(d)[3] > 0)
        else:
            save(name, make(np.random.default_rng(8)))
    # a rebuilt slot past twice the frame: key and inter frames at half of
    # the sequence's 88-sample maximum, the last rewritten 43 wide
    img = oracle.avif_image("photo", 64, 88, np.random.default_rng(3))
    stream = oracle.libaom_encode_frames(
        [inter_planes(f, 8, "420") for f in inter_frames(img, 3, 1, 2)], 8,
        1, 1, resize=(1, 16, 16),
        controls={"cpu-used": 5, "error-resilient-mode": 1})
    order, idx = oracle.ref_order_hints(stream)
    save("avif_rebuilt_too_large.avif", inter_avif(
        oracle.with_ref_order_hint(oracle.with_frame_size(stream, 43, 32),
                                   idx[0], order[idx[0]] + 1), 88, 64, 8,
        "420"))
    # the primary reference frame of a frame a buffer no frame was decoded
    # into (the frame before rebuilt its slot and refreshed none)
    img = oracle.avif_image("photo", 48, 64, np.random.default_rng(12))
    stream = oracle.libaom_encode_frames(
        [inter_planes(f, 8, "420") for f in inter_frames(img, 5, 1, 2)], 8,
        1, 1, flags={2: oracle.AOM_EFLAG_ERROR_RESILIENT | (7 << 23)},
        controls={"cpu-used": 5})
    refs = oracle.frame_refs(stream, 3)
    slot = refs["idx"][refs["primary"]]
    order, _ = oracle.ref_order_hints(stream, 2)
    save("avif_rebuilt_fresh_primary.avif", inter_avif(
        oracle.with_ref_order_hint(stream, slot, order[slot] + 3, 2), 64, 48,
        8, "420"))
    view = cv2.imread(p(TIMING))
    find_fixture(p(TIMING_REBUILT), lambda r: rebuilt_timing_view(view, r),
                 lambda data: rebuilt_info(data)[2] > 0, tries=1)
    dec = np.ascontiguousarray(cv2.imread(p(TIMING_REBUILT))[..., ::-1])
    mid = {}
    if mid_scene is not None:
        src = os.path.join(mid_scene, "images_4")
        os.makedirs(p(AVIF_MID_REBUILT), exist_ok=True)
        jobs = [(os.path.join(src, name), k,
                 p(os.path.join(AVIF_MID_REBUILT, name[:-4] + ".avif")))
                for k, name in enumerate(sorted(os.listdir(src)))]
        with multiprocessing.get_context("spawn").Pool(4) as pool:
            pool.map(_rebuilt_mid_job, jobs)
        for _, _, out in jobs:
            d = np.ascontiguousarray(cv2.imread(out)[..., ::-1])
            mid[os.path.basename(out)] = hashlib.sha256(
                d.tobytes()).hexdigest()
    return {TIMING_REBUILT: hashlib.sha256(dec.tobytes()).hexdigest()}, mid


def rebuilt_timing_view(bgr: np.ndarray, r) -> bytes:
    """TIMING_REBUILT: libaom's error resilient frames (speed 6, cq 20) of
    the view translated twice and once by TIMING_INTER_SHIFT, then the
    view, the last frame's first slot its references name and a block
    predicts from rebuilt (rebuilt_stream)."""
    import torch_avif_oracles as oracle

    h, w = bgr.shape[:2]
    stream = oracle.libaom_encode_frames(
        [yuv_planes(translated(bgr, TIMING_INTER_SHIFT[0] * t,
                               TIMING_INTER_SHIFT[1] * t), 6)
         for t in (2, 1, 0)], 8, 1, 1, controls={
            "cpu-used": 6, "cq-level": 20, "error-resilient-mode": 1})
    wrap = lambda st: inter_avif(st, w, h, 8, "420")     # noqa: E731
    out = rebuilt_stream(stream, "named", r, wrap)
    return None if out is None else wrap(out)

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


# the hand lossless frames' one Huffman table (counts of codes by length
# 1-16): difference categories 0-13 in 4 bits, 14-16 in 5 (no code is all
# ones)
_LOSSLESS_BITS = (0, 0, 0, 14, 3) + (0,) * 11


def _huffman_codes(bits) -> dict:
    """A DHT table's canonical codes: symbol (0, 1, ...) -> (code, length)."""
    codes, code, sym = {}, 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            codes[sym] = (code, length)
            code, sym = code + 1, sym + 1
        code <<= 1
    return codes


class _BitWriter:
    """JPEG entropy-coded bytes: MSB-first bits, 0xFF stuffed with 0x00,
    one bits padding a byte before a marker."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int):
        self.acc, self.n = (self.acc << n) | (value & ((1 << n) - 1)), \
            self.n + n
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.out += b"\xff\x00" if byte == 0xFF else bytes([byte])
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)

    def marker(self, code: int):
        self.flush()
        self.out += bytes([0xFF, code])


def _segment(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def _lossless_prediction(p: np.ndarray, first_rows, psv: int,
                         pt: int) -> np.ndarray:
    """The differences of a component's point-transformed samples ``p``
    under predictor ``psv``, as libjpeg-turbo undoes them: Ra along each
    row in ``first_rows`` (its first sample from 1 << (7 - pt)), Rb for
    the first sample of every other row, the predictor elsewhere; mod
    2^16 as signed values."""
    d = np.zeros(p.shape, np.int64)
    for y in range(p.shape[0]):
        for x in range(p.shape[1]):
            ra = p[y, x - 1] if x else 0
            if y in first_rows:
                pred = ra if x else 1 << (7 - pt)
            elif x == 0:
                pred = p[y - 1, 0]
            else:
                rb, rc = p[y - 1, x], p[y - 1, x - 1]
                pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                        rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv - 1]
            v = (int(p[y, x]) - int(pred)) & 0xFFFF
            d[y, x] = v - 0x10000 if v >= 0x8000 else v
    return d


def _lossless_difference(bw: _BitWriter, codes: dict, d: int):
    s = abs(d).bit_length()
    bw.put(*codes[s])
    if 0 < s < 16:
        bw.put(d if d > 0 else d + (1 << s) - 1, s)


def lossless_jpeg(planes, height: int, width: int, sampling=None, psv=1,
                  pt=0, restart=0, marker=0xC3, interleave=True) -> bytes:
    """A lossless JPEG (T.81 Annex H) written by hand, for the kinds no
    writer here makes: components sampled ``sampling`` ((h, v) each,
    default 1 x 1), a restart interval of ``restart`` MCUs (any count, the
    RST markers where it puts them), the frame marker ``marker`` (0xC3, or
    0xCB, SOF11, which labels the Huffman-coded scan arithmetic-coded),
    one interleaved scan or (``interleave`` False) a scan a component.
    ``planes`` holds each component's 8-bit samples at its own size,
    ceil(height · v / vmax) x ceil(width · h / hmax).  Like libjpeg-turbo
    3's lossless RGB files: an Adobe marker of transform 0, components
    'R', 'G', 'B', one DHT table.  The prediction is the decoder's
    (jddiffct.c, jdlossls.c): a component's rows are undone an iMCU row (v
    rows) at a time, and the first row undone after the scan's start or a
    restart (whole MCU rows only; an interval that splits a row resets
    nothing) takes Ra, whichever of the iMCU row's MCU rows the restart
    came before; samples padding an MCU past a component's edge are coded
    as 0."""
    ncomp = len(planes)
    sampling = sampling or [(1, 1)] * ncomp
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    codes = _huffman_codes(_LOSSLESS_BITS)
    ids = [b"RGB"[k] if ncomp == 3 else k + 1 for k in range(ncomp)]
    out = b"\xff\xd8" + _segment(0xEE, b"Adobe\x00\x64" + bytes(5))
    sof = bytes([8]) + struct.pack(">HHB", height, width, ncomp)
    for k, (h, v) in enumerate(sampling):
        sof += bytes([ids[k], h << 4 | v, 0])
    out += _segment(marker, sof)
    out += _segment(0xC4, bytes([0]) + bytes(_LOSSLESS_BITS)
                    + bytes(range(17)))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    scans = [list(range(ncomp))] if interleave else [[k] for k in
                                                       range(ncomp)]
    for scan in scans:
        lone = len(scan) == 1
        sos = bytes([len(scan)])
        for k in scan:
            sos += bytes([ids[k], 0])
        out += _segment(0xDA, sos + bytes([psv, 0, pt]))
        # the scan's MCU grid: one sample of a lone component, else each
        # component's h x v samples
        per_row = planes[scan[0]].shape[1] if lone else -(-width // hmax)
        mrows = planes[scan[0]].shape[0] if lone else -(-height // vmax)
        diffs = {}
        for k in scan:
            h, v = sampling[k]
            plane = planes[k].astype(np.int64) >> pt
            mh = 1 if lone else v
            # the MCU rows after which a restart comes, and so the first
            # row of each iMCU row (v rows) that holds one
            firsts = {0}
            if restart and restart % per_row == 0:
                for m in range(restart, per_row * mrows, restart):
                    firsts.add(m // per_row * mh // v * v)
            diffs[k] = _lossless_prediction(plane, firsts, psv, pt)
        bw = _BitWriter()
        for m in range(per_row * mrows):
            if restart and m and m % restart == 0:
                bw.marker(0xD0 + (m // restart - 1) % 8)
            my, mx = divmod(m, per_row)
            for k in scan:
                h, v = (1, 1) if lone else sampling[k]
                d = diffs[k]
                for yy in range(v):
                    for xx in range(h):
                        y, x = my * v + yy, mx * h + xx
                        _lossless_difference(
                            bw, codes, int(d[y, x]) if y < d.shape[0]
                            and x < d.shape[1] else 0)
        bw.flush()
        out += bytes(bw.out)
    return out + b"\xff\xd9"


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


def lzw_old_style(data: bytes, clear_at: int = 4094,
                  stats: dict | None = None) -> bytes:
    """Old-style TIFF LZW, the codes libtiff decodes with LZWDecodeCompat:
    LSB first, a CLEAR first and whenever the next free entry reaches
    ``clear_at``, the code width grown once the decoder's next free entry
    passes 2^nbits - 1 (one code after the new style's early change), EOI
    last.  Plain Python.  ``stats``, where given, gets the widest code
    (``max_bits``) and the CLEARs after the first (``clears``)."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, nbits):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += nbits
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
    # the decoder's state: its next free entry, its width, and whether the
    # next code is the first after a CLEAR (which adds no entry)
    dec = {"free": 258, "nbits": 9, "fresh": True}

    def emit(code):
        put(code, dec["nbits"])
        if dec["fresh"]:
            dec["fresh"] = False
            return
        dec["free"] += 1
        if dec["free"] > (1 << dec["nbits"]) - 1 and dec["nbits"] < 12:
            dec["nbits"] += 1
            seen["max_bits"] = max(seen.get("max_bits", 9), dec["nbits"])

    def clear():
        seen["max_bits"] = max(seen.get("max_bits", 9), dec["nbits"])
        put(256, dec["nbits"])
        dec.update(free=258, nbits=9, fresh=True)
        seen["clears"] += 1
    seen = {"clears": -1}
    clear()
    table, free = {}, 258
    if data:
        cur = data[0]
        for c in data[1:]:
            if (cur, c) in table:
                cur = table[(cur, c)]
                continue
            emit(cur)
            table[(cur, c)] = free
            free += 1
            cur = c
            if free == clear_at:
                clear()
                table, free = {}, 258
        emit(cur)
    put(257, dec["nbits"])
    if nacc:
        out.append(acc & 0xFF)
    if stats is not None:
        stats.update(clears=seen["clears"], max_bits=seen["max_bits"])
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits (tif_packbits.c's format): runs of 3 or more equal bytes as
    a repeat, the rest as literals of up to 128 bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def horizontal_differences(buf: bytes, rowsize: int, stride: int) -> bytes:
    """8-bit Predictor 2 as libtiff's horDiff8 writes it: each row of
    ``rowsize`` bytes differenced ``stride`` bytes back (mod 256)."""
    a = np.frombuffer(buf, np.uint8).reshape(-1, rowsize // stride, stride)
    d = a.copy()
    d[:, 1:] -= a[:, :-1]
    return d.tobytes()


def ycbcr_units(px: np.ndarray, rows: int, cols: int, hs: int,
                vs: int) -> bytes:
    """The data units of (rows, cols) YCbCr samples subsampled hs x vs: hs ·
    vs luma samples, then the block's Cb and Cr (its top-left sample's);
    blocks past the edge padded with the edge's samples."""
    ys = np.minimum(np.arange(-(-rows // vs) * vs), px.shape[0] - 1)
    xs = np.minimum(np.arange(-(-cols // hs) * hs), px.shape[1] - 1)
    full = px[ys][:, xs].astype(np.uint8)
    by, bx = full.shape[0] // vs, full.shape[1] // hs
    y = full[..., 0].reshape(by, vs, bx, hs).transpose(0, 2, 1, 3).reshape(
        by, bx, vs * hs)
    chroma = full[::vs, ::hs, 1:]
    return np.concatenate([y, chroma], 2).tobytes()


def write_tiff_file(path, samples, **kw):
    """``tiff_bytes(samples, **kw)`` written to ``path``."""
    with open(path, "wb") as f:
        f.write(tiff_bytes(samples, **kw))


def tiff_bytes(samples, bps=8, photometric=None, compression=1, predictor=1,
               planar=1, tile=None, rows_per_strip=None, endian="<",
               colormap=None, extra_samples=None, subsampling=None,
               old_lzw=False, fill_order=1, orientation=None, tags=None,
               ycbcr_rows="libtiff") -> bytes:
    """A one-image TIFF: strips or tiles, chunky or planar, II or MM, no
    compression, LZW (``old_lzw``: old-style codes), Deflate (8 or 32946)
    or PackBits, predictor 2 at 8 or 16 bits; FillOrder 2 (each chunk's
    bytes bit-reversed), an orientation, and any other SHORT, LONG or
    RATIONAL ``tags`` ({tag: (type, values)}, a RATIONAL's values as
    numerator, denominator pairs).  With ``subsampling`` (YCbCr, photometric
    6, 8 bits, chunky) each strip or tile holds data units
    (``ycbcr_units``), the size libtiff reads, and Predictor 2 differences
    them as libtiff's predictor undoes them (``ycbcr_rows`` "libtiff"):
    rows of TIFFScanlineSize (a row of sample blocks over the vertical
    subsampling) in a strip, of the tile's width times 3 bytes in a tile,
    3 bytes back, over the bytes libtiff decodes (a strip's whole rows of
    blocks cut to nrowsub · TIFFScanlineSize), none where a tile is not a
    whole number of such rows or a row not of whole 3-byte groups;
    "pixels" differences each row of blocks unit by unit instead, what no
    reader undoes."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    if photometric is None:
        photometric = 1 if spp == 1 else 2
    planes = ([samples[..., k:k + 1] for k in range(spp)] if planar == 2
              else [samples])

    def compress(raw):
        if compression == 5:
            raw = lzw_old_style(raw) if old_lzw else _lzw(raw)
        elif compression in (8, 32946):
            raw = zlib.compress(raw)
        elif compression == 32773:
            raw = packbits(raw)
        if fill_order == 2:
            raw = np.packbits(np.unpackbits(np.frombuffer(raw, np.uint8))
                              .reshape(-1, 8)[:, ::-1]).tobytes()
        return raw

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
        return compress(raw)

    def encode_units(block, rows, tiled):
        hs, vs = subsampling
        cols = block.shape[1]
        raw = ycbcr_units(block, rows, cols, hs, vs)
        if predictor == 2:
            unit = hs * vs + 2
            if ycbcr_rows == "pixels":
                raw = horizontal_differences(raw, -(-cols // hs) * unit,
                                             unit)
            elif tiled:
                if len(raw) % (3 * cols) == 0:
                    raw = horizontal_differences(raw, 3 * cols, 3)
            else:
                scan = -(-w // hs) * unit // vs
                n = min(len(raw), -(-rows // vs) * vs * scan)
                if scan % 3 == 0:
                    raw = horizontal_differences(raw[:n], scan, 3) + raw[n:]
        return compress(raw)

    chunks = []
    for plane in planes:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    part = plane[ty:ty + th, tx:tx + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    if subsampling:
                        blk[part.shape[0]:] = blk[part.shape[0] - 1]
                        blk[:, part.shape[1]:] = blk[:, part.shape[1] - 1:
                                                     part.shape[1]]
                        chunks.append(encode_units(blk, th, True))
                    else:
                        chunks.append(encode(blk))
        else:
            rps = rows_per_strip or h
            for y in range(0, h, rps):
                part = plane[y:y + rps]
                chunks.append(encode_units(part, part.shape[0], False)
                              if subsampling else encode(part))
    e = endian
    body = bytearray(b"II*\x00" if e == "<" else b"MM\x00*") + bytes(4)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + b"\x00" * (len(c) % 2)
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp),
              259: (3, [compression]), 262: (3, [photometric]),
              277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        fields[317] = (3, [predictor])
    if tile:
        fields.update({322: (3, [tile[0]]), 323: (3, [tile[1]]),
                       324: (4, offsets),
                       325: (4, [len(c) for c in chunks])})
    else:
        fields.update({273: (4, offsets),
                       279: (4, [len(c) for c in chunks]),
                       278: (4, [rows_per_strip or h])})
    if colormap is not None:
        fields[320] = (3, list(np.asarray(colormap).T.reshape(-1)))
    if extra_samples is not None:
        fields[338] = (3, list(extra_samples))
    if subsampling is not None:
        fields[530] = (3, list(subsampling))
    if fill_order != 1:
        fields[266] = (3, [fill_order])
    if orientation is not None:
        fields[274] = (3, [orientation])
    fields.update(tags or {})
    entries = []
    for t in sorted(fields):
        typ, vals = fields[t]
        code = {3: "H", 4: "I", 5: "II"}[typ]
        count = len(vals) // 2 if typ == 5 else len(vals)
        raw = struct.pack(e + code[0] * len(vals), *vals)
        if len(raw) > 4:
            entries.append(struct.pack(e + "HHII", t, typ, count,
                                       len(body)))
            body += raw + b"\x00" * (len(raw) % 2)
        else:
            entries.append(struct.pack(e + "HHI", t, typ, count)
                           + raw.ljust(4, b"\x00"))
    ifd = len(body)
    body += struct.pack(e + "H", len(entries)) + b"".join(entries) + bytes(4)
    body[4:8] = struct.pack(e + "I", ifd)
    return bytes(body)


# the D50 white point and display_sRGB of libtiff's RGBA interface
# (tif_getimage.c), for the CIELab writers below
_D50 = (96.4250, 100.0, 82.4680)
_SRGB = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                  [0.0556, -0.2040, 1.0570]])


def rgb_to_cielab16(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB → 16-bit CIELab samples (L · 65535 / 100, a and
    b · 256 as int16 in uint16), the inverse of libtiff's display_sRGB
    conversion (gamma 2.4 over light output 1-100, its matrix, D50)."""
    lum = 1 + 99 * (rgb.astype(np.float64) / 255) ** 2.4
    xyz = lum @ np.linalg.inv(_SRGB).T
    ref = np.array(_D50)

    def f(t):
        return np.where(t > 0.008856, np.cbrt(t), 7.787 * t + 16 / 116)
    fx_, fy, fz = (f(xyz[..., k] / ref[k]) for k in range(3))
    L = np.where(xyz[..., 1] / ref[1] > 0.008856, 116 * fy - 16,
                 903.292 * xyz[..., 1] / ref[1])
    a, b = 500 * (fx_ - fy), 200 * (fy - fz)
    out = np.stack([np.clip(np.rint(L / 100 * 65535), 0, 65535),
                    np.clip(np.rint(a * 256), -32768, 32767),
                    np.clip(np.rint(b * 256), -32768, 32767)], -1)
    return out.astype(np.int64).astype(np.uint16)


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB → full-range BT.601 YCbCr samples (libtiff's
    default YCbCrCoefficients and ReferenceBlackWhite)."""
    x = rgb.astype(np.float64)
    y = x @ np.array([0.299, 0.587, 0.114])
    cb = 128 + (x[..., 2] - y) / 1.772
    cr = 128 + (x[..., 0] - y) / 1.402
    return np.clip(np.rint(np.stack([y, cb, cr], -1)), 0, 255).astype(
        np.uint8)


def _noise(shape, hi: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, hi, shape)


def kinds_files() -> dict:
    """name -> bytes of KINDS_CASES and KINDS_REFUSED, written here with
    numpy and the standard library alone (fixture_image and seeded
    noise)."""
    out = {}
    img = fixture_image(37, 45, seed=27)
    lab = rgb_to_cielab16(img)
    # the signed ends of a and b, and L's
    lab[0, :4] = [(0, 0x8000, 0x7FFF), (65535, 0x7FFF, 0x8000),
                  (0, 0, 0xFFFF), (65535, 0xFFFF, 0)]
    for name, kw in (("none", {}),
                     ("lzw_pred", dict(compression=5, predictor=2,
                                       rows_per_strip=8)),
                     ("deflate_pred", dict(compression=8, predictor=2,
                                           rows_per_strip=5)),
                     ("packbits", dict(compression=32773)),
                     ("tiles_mm", dict(compression=5, predictor=2,
                                       tile=(16, 32), endian=">"))):
        out[f"tiff_lab16_{name}.tif"] = tiff_bytes(lab, bps=16,
                                                   photometric=8, **kw)
    square = rgb_to_cielab16(fixture_image(32, 32, seed=28))
    for o in (3, 6):
        out[f"tiff_lab16_orient{o}.tif"] = tiff_bytes(
            square, bps=16, photometric=8, compression=8, orientation=o)
    out["tiff_lab16_white.tif"] = tiff_bytes(
        _noise((20, 30, 3), 1 << 16, 29), bps=16, photometric=8,
        tags={318: (5, [31271, 100000, 32902, 100000])})
    ycc = rgb_to_ycbcr(img)
    # widths whose rows of sample blocks libtiff's predictor undoes
    # (TIFFScanlineSize a multiple of 3)
    for sub, w in (((1, 2), 45), ((2, 1), 42), ((2, 2), 45), ((4, 1), 45),
                   ((4, 2), 45), ((4, 4), 45)):
        out[f"tiff_ycbcr_pred_{sub[0]}{sub[1]}.tif"] = tiff_bytes(
            ycc[:, :w], photometric=6, subsampling=sub, compression=5,
            predictor=2, rows_per_strip=8)
    out["tiff_ycbcr_pred_22_deflate.tif"] = tiff_bytes(
        ycc, photometric=6, subsampling=(2, 2), compression=8, predictor=2,
        rows_per_strip=6)
    for sub in ((2, 2), (4, 2)):
        out[f"tiff_ycbcr_pred_{sub[0]}{sub[1]}_tiles.tif"] = tiff_bytes(
            ycc, photometric=6, subsampling=sub, compression=5, predictor=2,
            tile=(16, 16))
    odd = rgb_to_ycbcr(fixture_image(37, 50, seed=30))  # 13 blocks a row
    out["tiff_ycbcr_pred_44_odd.tif"] = tiff_bytes(
        odd, photometric=6, subsampling=(4, 4), compression=8, predictor=2,
        rows_per_strip=8)
    out["tiff_ycbcr_pred_pixels.tif"] = tiff_bytes(
        ycc, photometric=6, subsampling=(2, 2), compression=5, predictor=2,
        rows_per_strip=8, ycbcr_rows="pixels")
    out["tiff_ycbcr_44_edge_tiles.tif"] = tiff_bytes(
        ycc, photometric=6, subsampling=(4, 4), tile=(16, 16))
    out["tiff_lzw_old_rgb.tif"] = tiff_bytes(
        _noise((64, 64, 3), 256, 31), compression=5, old_lzw=True)
    out["tiff_lzw_old_pred.tif"] = tiff_bytes(
        img, compression=5, predictor=2, old_lzw=True, rows_per_strip=16)
    out["tiff_lzw_old_gray16_mm.tif"] = tiff_bytes(
        _noise((29, 38), 1 << 16, 32), bps=16, compression=5, predictor=2,
        old_lzw=True, endian=">", rows_per_strip=10)
    out["tiff_lzw_old_tiles.tif"] = tiff_bytes(
        img, compression=5, old_lzw=True, tile=(16, 16))
    out["tiff_lzw_old_planar.tif"] = tiff_bytes(
        img, compression=5, old_lzw=True, planar=2, rows_per_strip=12)
    out["tiff_lzw_old_fill2.tif"] = tiff_bytes(
        img, compression=5, old_lzw=True, fill_order=2, rows_per_strip=20)
    out["tiff_gray16_alpha_planar.tif"] = tiff_bytes(
        _noise((23, 31, 2), 1 << 16, 38), bps=16, photometric=1, planar=2,
        extra_samples=[2], compression=8, predictor=2)
    out["tiff_palette_extra.tif"] = tiff_bytes(
        np.concatenate([img[..., :1], img[..., 1:2]], 2), photometric=3,
        extra_samples=[0], colormap=_noise((256, 3), 1 << 16, 39),
        compression=5)
    h, w = 29, 38
    rgb = fixture_image(h, w, seed=33)

    def planes(sampling):
        hmax = max(a for a, _ in sampling)
        vmax = max(b for _, b in sampling)
        return [rgb[::vmax // v, ::hmax // hh, k]
                for k, (hh, v) in enumerate(sampling)]
    s22 = [(2, 2), (1, 1), (1, 1)]
    out["jpeg_lossless_sub22.jpg"] = lossless_jpeg(planes(s22), h, w, s22)
    s21 = [(2, 1), (1, 1), (1, 1)]
    out["jpeg_lossless_sub21_restart.jpg"] = lossless_jpeg(
        planes(s21), h, w, s21, psv=5, pt=2, restart=2 * 19)
    mixed = [(2, 2), (2, 1), (1, 2)]
    out["jpeg_lossless_sub_mixed.jpg"] = lossless_jpeg(planes(mixed), h, w,
                                                       mixed, psv=7)
    out["jpeg_lossless_sub_scans.jpg"] = lossless_jpeg(
        planes(s22), h, w, s22, psv=4, interleave=False)
    out["jpeg_lossless_sub_cut.jpg"] = _cut(out["jpeg_lossless_sub22.jpg"],
                                            0.6)
    # the refused kinds
    v8, v16 = _noise((12, 16, 3), 256, 34), _noise((12, 16, 3), 1 << 16, 35)
    x8, x16 = _noise((12, 16, 4), 256, 36), _noise((12, 16, 4), 1 << 16, 37)
    out["tiff_refused_ycbcr16.tif"] = tiff_bytes(
        v16, bps=16, photometric=6, tags={530: (3, [1, 1])})
    out["tiff_refused_ycbcr16_sub.tif"] = tiff_bytes(
        v16, bps=16, photometric=6, tags={530: (3, [2, 2])})
    out["tiff_refused_ycbcr_extra.tif"] = tiff_bytes(
        x8, photometric=6, extra_samples=[0], tags={530: (3, [1, 1])})
    out["tiff_refused_ycbcr16_extra.tif"] = tiff_bytes(
        x16, bps=16, photometric=6, extra_samples=[2])
    out["tiff_refused_lab_extra.tif"] = tiff_bytes(
        x8, photometric=8, extra_samples=[0])
    out["tiff_refused_lab16_extra.tif"] = tiff_bytes(
        x16, bps=16, photometric=8, extra_samples=[2])
    out["tiff_refused_lab_planar.tif"] = tiff_bytes(
        v16, bps=16, photometric=8, planar=2)
    out["tiff_refused_icclab.tif"] = tiff_bytes(v8, photometric=9)
    out["tiff_refused_itulab.tif"] = tiff_bytes(v16, bps=16, photometric=10)
    out["tiff_refused_rgb_5_samples.tif"] = tiff_bytes(
        _noise((12, 16, 5), 256, 40), extra_samples=[0, 0])
    out["tiff_refused_fill2_tile.tif"] = tiff_bytes(
        _noise((20, 20, 3), 256, 41), tile=(16, 16), fill_order=2)
    out["tiff_refused_ojpeg.tif"] = tiff_bytes(
        v8, photometric=6, compression=6,
        tags={512: (3, [1]), 513: (4, [8]), 514: (4, [0])})
    one = [rgb[..., k] for k in range(3)]
    out["jpeg_refused_sof11.jpg"] = lossless_jpeg(one, h, w, marker=0xCB)
    out["jpeg_refused_split_restart.jpg"] = lossless_jpeg(one, h, w,
                                                          restart=5)
    big = [(4, 4), (2, 2), (1, 1)]
    out["jpeg_refused_mcu_samples.jpg"] = lossless_jpeg(planes(big), h, w,
                                                        big)
    return out


def tiff_mid_file(rgb: np.ndarray, k: int) -> bytes:
    """View k of chip_smoke's tiff_mid_kinds leg (TIFF_MID_KINDS[k % 3]):
    16-bit CIELab (Deflate, Predictor 2, strips of 8 rows), 4:2:0 YCbCr
    (chroma averaged over each 2x2 block; LZW, Predictor 2, strips of 8
    rows) or old-style LZW RGB (strips of 16 rows)."""
    kind = k % 3
    if kind == 0:
        return tiff_bytes(rgb_to_cielab16(rgb), bps=16, photometric=8,
                          compression=8, predictor=2, rows_per_strip=8)
    if kind == 1:
        h, w = rgb.shape[:2]
        ycc = rgb_to_ycbcr(rgb).astype(np.float64)
        pad = np.pad(ycc, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
        mean = pad.reshape(pad.shape[0] // 2, 2, pad.shape[1] // 2, 2,
                           3).mean((1, 3))
        ycc[..., 1:] = np.repeat(np.repeat(mean, 2, 0), 2, 1)[:h, :w, 1:]
        return tiff_bytes(np.rint(ycc).astype(np.uint8), photometric=6,
                          subsampling=(2, 2), compression=5, predictor=2,
                          rows_per_strip=8)
    return tiff_bytes(rgb, compression=5, old_lzw=True, rows_per_strip=16)


def generate_kinds(folder: str = FOLDER) -> dict:
    """KINDS_CASES and KINDS_REFUSED (kinds_files); returns the SHA-256 of
    cv2's decode of each tiff_mid_file view of AVIF_MID's views, for
    TIFF_MID_SHA256."""
    import hashlib

    import cv2

    for name, data in kinds_files().items():
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)
    shas = {}
    src = os.path.join(folder, AVIF_MID)
    with tempfile.TemporaryDirectory() as tmp:
        for k, name in enumerate(sorted(os.listdir(src))):
            rgb = np.ascontiguousarray(cv2.imread(os.path.join(
                src, name))[..., ::-1])
            path = os.path.join(tmp, name[:-5] + ".tif")
            with open(path, "wb") as f:
                f.write(tiff_mid_file(rgb, k))
            dec = np.ascontiguousarray(cv2.imread(path)[..., ::-1])
            shas[os.path.basename(path)] = hashlib.sha256(
                dec.tobytes()).hexdigest()
    return shas


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
    for name in GARBLED:
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
    source; for ``TIMING_AVIF``, where the decode hashes as cv2's.
    ``scratch`` is a directory for the writers' files (a
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
    for name, sha in {**TIMING_AVIF, **TIMING_TIFF}.items():
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
    if sys.argv[1:2] == ["--avis"]:         # the image sequences alone;
        shas = generate_avis(               # --avis SCENE also writes the
            mid_scene=(sys.argv[2:] or [None])[0])   # mid views' copies
        _write_wants(AVIS_CASES)
        print(f"AVIS SHA-256s for TIMING_AVIF = {shas!r}")
        sys.exit(0)
    if sys.argv[1:2] == ["--colour"]:       # the colour and orientation
        shas = generate_colour(             # kinds alone; --colour SCENE
            mid_scene=(sys.argv[2:] or [None])[0])   # also the mid views
        _write_wants(AVIF_COLOUR_CASES + TIFF_COLOUR_CASES)
        _check_cv2_refuses()
        print(f"colour SHA-256s for TIMING_AVIF and TIMING_TIFF = {shas!r}")
        sys.exit(0)
    if sys.argv[1:2] == ["--libavif"]:      # superres, delta LF,
        shas = generate_libavif(            # libavif's own path and
            mid_scene=(sys.argv[2:] or [None])[0])   # scaling; --libavif
        _write_wants(AVIF_LIBAVIF_CASES)    # SCENE also the mid views
        _check_cv2_refuses()
        print(f"libavif SHA-256s for TIMING_AVIF = {shas!r}")
        result = check()
        print({k: v for k, v in result.items() if not v})
        sys.exit(0)
    if sys.argv[1:2] == ["--inter"]:        # AV1 frames after the first;
        shas = generate_inter(              # --inter SCENE also writes
            mid_scene=(sys.argv[2:] or [None])[0])   # the mid views
        _write_wants(AVIF_INTER_CASES)
        _check_cv2_refuses()
        print(f"inter SHA-256 for TIMING_AVIF = {shas!r}")
        result = check()
        print({k: v for k, v in result.items() if not v})
        sys.exit(0)
    if sys.argv[1:2] == ["--inter-tools"]:  # the inter tools at libaom's
        shas = generate_inter_tools(        # defaults; --inter-tools SCENE
            mid_scene=(sys.argv[2:] or [None])[0])   # also the mid views
        _write_wants(AVIF_TOOLS_CASES)
        _check_cv2_refuses()
        print(f"inter tools SHA-256 for TIMING_AVIF = {shas!r}")
        result = check()
        print({k: v for k, v in result.items() if not v})
        sys.exit(0)
    if sys.argv[1:2] == ["--scaled"]:       # references of another size
        shas = generate_scaled(             # and switch frames; --scaled
            mid_scene=(sys.argv[2:] or [None])[0])   # SCENE also the mid
        _write_wants(AVIF_SCALED_CASES)              # views
        _check_cv2_refuses()
        print(f"scaled SHA-256 for TIMING_AVIF = {shas!r}")
        result = check()
        print({k: v for k, v in result.items() if not v})
        sys.exit(0)
    if sys.argv[1:2] == ["--rebuilt"]:      # reference slots rebuilt from
        shas, mid = generate_rebuilt(       # ref_order_hint; --rebuilt
            mid_scene=(sys.argv[2:] or [None])[0])   # SCENE also the mid
        _write_wants(AVIF_REBUILT_CASES)             # views
        _check_cv2_refuses()
        print(f"rebuilt SHA-256 for TIMING_AVIF = {shas!r}")
        print(f"REBUILT_MID_SHA256 = {mid!r}")
        result = check()
        print({k: v for k, v in result.items() if not v})
        sys.exit(0)
    if sys.argv[1:2] == ["--compound"]:     # compound prediction and skip
        shas = generate_compound(           # mode; --compound SCENE also
            mid_scene=(sys.argv[2:] or [None])[0])   # the mid views
        _write_wants(AVIF_COMPOUND_CASES)
        _check_cv2_refuses()
        print(f"compound SHA-256 for TIMING_AVIF = {shas!r}")
        result = check()
        print({k: v for k, v in result.items() if not v})
        sys.exit(0)
    if sys.argv[1:] == ["--j2k-ht"]:        # HT, JPH and Part 2 JPEG 2000
        mid, timing = generate_j2k_ht()     # (also the system libopenjp2)
        _write_wants(J2K_HT_CASES)
        _check_cv2_refuses()
        print(f"J2K_MID_SHA256 = {mid!r}")
        print(f"TIMING_JPH_SHA256 = {timing!r}")
        result = check()
        print({k: v for k, v in result.items() if not v})
        sys.exit(0 if all(result.values()) else 1)
    if sys.argv[1:] == ["--kinds"]:         # the TIFF and JPEG kinds of
        shas = generate_kinds()             # KINDS_CASES and KINDS_REFUSED
        _write_wants(KINDS_CASES)
        _check_cv2_refuses()
        print(f"TIFF_MID_SHA256 = {shas!r}")
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
