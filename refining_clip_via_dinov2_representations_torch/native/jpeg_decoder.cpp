// Native JPEG decode with DCT-domain downscaling.
//
// The reference's host input pipeline decodes every JPEG at full resolution
// through PIL, then bicubic-resizes down to the training size
// (src/open_clip/transform.py eval/train pipelines). For the device-
// preprocess path (ops/preprocess.py) the host only needs a uint8 image
// whose shortest edge is >= the raw staging size (default 256) — so a
// full-resolution decode of a 1–4 MP photo wastes most of its IDCT work.
//
// libjpeg can apply an M/8 (M=1..8) scale *inside* the decoder: it runs the
// inverse DCT at reduced block size, cutting decode cost roughly by (M/8)^2.
// This core picks the smallest M whose scaled shortest edge still covers
// `target_min`, decodes straight into an RGB8 buffer, and hands it back over
// a minimal C ABI (ctypes). The Python side finishes with the exact
// shortest-edge bicubic + center-crop on the (much smaller) image.
//
// Interface (see native/__init__.py: decode_jpeg):
//   rcd_jpeg_decode(data, len, target_min, &out, &w, &h) -> 0 | negative error
//     out: malloc'd w*h*3 RGB8 buffer, caller frees via rcd_jpeg_free.
//     target_min <= 0 disables scaling (full-size decode).
//   errors: -1 malformed/decode failure, -2 unsupported colorspace (CMYK),
//           -3 allocation failure. On error nothing is allocated.
//
// Unsupported inputs (CMYK/YCCK, corrupt streams) return an error and the
// Python caller falls back to the PIL path — behavior stays a superset.

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
    ErrorMgr* mgr = reinterpret_cast<ErrorMgr*>(cinfo->err);
    longjmp(mgr->jump, 1);
}

// Silence output but keep the count: in libjpeg it is emit_message itself
// that increments num_warnings for corrupt-data warnings (msg_level < 0),
// so an empty override would hide truncation from the post-decode check.
void emit_message(j_common_ptr cinfo, int msg_level) {
    if (msg_level < 0) cinfo->err->num_warnings++;
}

}  // namespace

extern "C" {

int rcd_jpeg_decode(const unsigned char* data, long len, int target_min,
                    unsigned char** out, int* out_w, int* out_h) {
    *out = nullptr;
    jpeg_decompress_struct cinfo;
    ErrorMgr err;
    cinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = error_exit;
    err.pub.emit_message = emit_message;
    // `volatile`: modified between setjmp and longjmp — without it the
    // error path reads an indeterminate value (C standard) and either
    // leaks the buffer or frees garbage
    unsigned char* volatile buf = nullptr;

    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&cinfo);
        std::free(buf);
        return -1;
    }

    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
                 static_cast<unsigned long>(len));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    if (cinfo.jpeg_color_space == JCS_CMYK ||
        cinfo.jpeg_color_space == JCS_YCCK) {
        jpeg_destroy_decompress(&cinfo);
        return -2;  // libjpeg cannot convert CMYK->RGB; PIL path handles it
    }

    // smallest M/8 scale whose shortest edge still covers target_min
    // (ceil(dim*M/8) is libjpeg's output rounding)
    int m = 8;
    if (target_min > 0) {
        const long w0 = cinfo.image_width, h0 = cinfo.image_height;
        for (int cand = 1; cand <= 8; ++cand) {
            long sw = (w0 * cand + 7) / 8, sh = (h0 * cand + 7) / 8;
            if (sw >= target_min && sh >= target_min) { m = cand; break; }
        }
    }
    cinfo.scale_num = static_cast<unsigned>(m);
    cinfo.scale_denom = 8;
    cinfo.out_color_space = JCS_RGB;
    jpeg_calc_output_dimensions(&cinfo);

    const long w = cinfo.output_width, h = cinfo.output_height;
    if (w <= 0 || h <= 0 || w * h > (1L << 28)) {  // 256 MP sanity cap
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    buf = static_cast<unsigned char*>(std::malloc(static_cast<size_t>(w) * h * 3));
    if (!buf) {
        jpeg_destroy_decompress(&cinfo);
        return -3;
    }

    jpeg_start_decompress(&cinfo);
    const long stride = static_cast<long>(cinfo.output_width) * cinfo.output_components;
    while (cinfo.output_scanline < cinfo.output_height) {
        unsigned char* row = buf + static_cast<size_t>(cinfo.output_scanline) * stride;
        JSAMPROW rows[1] = {row};
        jpeg_read_scanlines(&cinfo, rows, 1);
    }
    jpeg_finish_decompress(&cinfo);
    // Truncated/corrupt entropy data is a WARNING in libjpeg (it inserts a
    // fake EOI and fabricates gray scanlines), not an error_exit — without
    // this check a truncated file would silently train on half-gray pixels.
    // Any corrupt-data warning routes to the PIL fallback, matching the
    // documented "corrupt streams return an error" contract.
    if (err.pub.num_warnings > 0) {
        jpeg_destroy_decompress(&cinfo);
        std::free(buf);
        return -1;
    }
    jpeg_destroy_decompress(&cinfo);

    *out = buf;
    *out_w = static_cast<int>(w);
    *out_h = static_cast<int>(h);
    return 0;
}

void rcd_jpeg_free(unsigned char* p) { std::free(p); }

}  // extern "C"
