// p2io -- the port's host-IO core: chunked uint8 window reads and the zstd
// write path of p2igan_tpu_torch/data/zarrlite.py.
//
// Training reads a (T, H, W) uint8 window out of a zarr store, and a window
// touches one or two chunks. p2io_read_window_u8 reads, decodes (raw, zlib or
// gzip, zstd, blosc) and assembles those chunks straight into the caller's
// buffer, on the calling thread: the loader's threads call in at once, each
// without the interpreter lock (a ctypes call), so they are the parallelism.
//
// The zstd and blosc entry points are not linked: the binding hands in the
// function pointers of the libraries that zarrlite's own loaders open, so the
// library builds and loads where libblosc is absent. zlib is linked (CPython
// itself needs it). Plain C interface for ctypes; no exception leaves the
// library: every failure becomes a status the binding raises with.
//
// Build: p2igan_tpu_torch/data/native.py (g++ -O3 -shared -fPIC -std=c++17).

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

enum Codec { RAW = 0, ZLIB = 1, ZSTD = 2, BLOSC = 3 };

// A chunk's status, as the binding names it (native.py STATUS).
enum Status { OK = 0, UNREADABLE = 1, UNDECODABLE = 2, WRONG_SIZE = 3, NO_MEMORY = 4 };

typedef size_t (*ZstdDecompress)(void*, size_t, const void*, size_t);
typedef unsigned (*ZstdIsError)(size_t);
typedef size_t (*ZstdCompress)(void*, size_t, const void*, size_t, int);
typedef int (*BloscDecompress)(const void*, void*, size_t, int);

// The codec table the binding passes (native.py codec_table).
struct Codecs {
    ZstdDecompress zstd_decompress;
    ZstdIsError zstd_is_error;
    ZstdCompress zstd_compress;
    BloscDecompress blosc_decompress;
};

Codecs codecs_of(const void* const* fns) {
    Codecs c;
    c.zstd_decompress = reinterpret_cast<ZstdDecompress>(const_cast<void*>(fns[0]));
    c.zstd_is_error = reinterpret_cast<ZstdIsError>(const_cast<void*>(fns[1]));
    c.zstd_compress = reinterpret_cast<ZstdCompress>(const_cast<void*>(fns[2]));
    c.blosc_decompress = reinterpret_cast<BloscDecompress>(const_cast<void*>(fns[3]));
    return c;
}

// Read a whole file into buf; false if it cannot be opened or read.
bool read_file(const char* path, std::vector<uint8_t>& buf) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    long n = -1;
    if (std::fseek(f, 0, SEEK_END) == 0) n = std::ftell(f);
    bool ok = n >= 0 && std::fseek(f, 0, SEEK_SET) == 0;
    if (ok) {
        buf.resize(static_cast<size_t>(n));  // may throw: the caller catches
        ok = std::fread(buf.data(), 1, buf.size(), f) == buf.size();
    }
    std::fclose(f);
    return ok;
}

// Decode src into dst (dst_n bytes, the chunk's size). Sets *got to the
// decoded size where the codec reports it (-1: more than dst_n).
Status decode(const uint8_t* src, size_t src_n, uint8_t* dst, size_t dst_n,
              int codec, const Codecs& fn, int64_t* got) {
    *got = -1;
    switch (codec) {
        case RAW:
            *got = static_cast<int64_t>(src_n);
            if (src_n != dst_n) return WRONG_SIZE;
            std::memcpy(dst, src, dst_n);
            return OK;
        case ZLIB: {
            // windowBits 15 + 32: zlib (RFC 1950) or gzip (RFC 1952) framing,
            // detected from the header, so both codec ids decode here
            z_stream zs;
            std::memset(&zs, 0, sizeof(zs));
            if (inflateInit2(&zs, 15 + 32) != Z_OK) return NO_MEMORY;
            zs.next_in = const_cast<Bytef*>(src);
            zs.avail_in = static_cast<uInt>(src_n);
            zs.next_out = dst;
            zs.avail_out = static_cast<uInt>(dst_n);
            const int r = inflate(&zs, Z_FINISH);
            const bool full = zs.avail_out == 0;
            *got = static_cast<int64_t>(zs.total_out);
            inflateEnd(&zs);
            if (r == Z_STREAM_END) return *got == static_cast<int64_t>(dst_n) ? OK : WRONG_SIZE;
            if (r == Z_BUF_ERROR && full) {
                *got = -1;  // the stream goes on past the chunk's size
                return WRONG_SIZE;
            }
            return UNDECODABLE;
        }
        case ZSTD: {
            if (!fn.zstd_decompress || !fn.zstd_is_error) return UNDECODABLE;
            const size_t r = fn.zstd_decompress(dst, dst_n, src, src_n);
            if (fn.zstd_is_error(r)) return UNDECODABLE;
            *got = static_cast<int64_t>(r);
            return r == dst_n ? OK : WRONG_SIZE;
        }
        case BLOSC: {
            if (!fn.blosc_decompress) return UNDECODABLE;
            // r is the decoded byte count: a truncated chunk may decode to
            // fewer bytes, which must not pass as a whole chunk
            const int r = fn.blosc_decompress(src, dst, dst_n, 1);
            if (r < 0) return UNDECODABLE;
            *got = r;
            return static_cast<size_t>(r) == dst_n ? OK : WRONG_SIZE;
        }
        default:
            return UNDECODABLE;
    }
}

struct Window {
    int64_t st, sy, sx;  // chunk shape
    int64_t t0, y0, x0;  // window origin
    int64_t wt, wy, wx;  // window shape
};

// Decode one chunk into `chunk` (scratch) and copy its overlap with the
// window into `out`; a chunk without a file reads as zeros.
Status read_chunk(const char* path, const int32_t* cidx, const Window& w, int codec,
                  const Codecs& fn, std::vector<uint8_t>& raw,
                  std::vector<uint8_t>& chunk, uint8_t* out, int64_t* got) {
    const int64_t ct0 = cidx[0] * w.st, cy0 = cidx[1] * w.sy, cx0 = cidx[2] * w.sx;
    const int64_t at0 = std::max(ct0, w.t0), at1 = std::min(ct0 + w.st, w.t0 + w.wt);
    const int64_t ay0 = std::max(cy0, w.y0), ay1 = std::min(cy0 + w.sy, w.y0 + w.wy);
    const int64_t ax0 = std::max(cx0, w.x0), ax1 = std::min(cx0 + w.sx, w.x0 + w.wx);
    *got = -1;
    if (at1 <= at0 || ay1 <= ay0 || ax1 <= ax0) return OK;
    const size_t span = static_cast<size_t>(ax1 - ax0);
    if (path == nullptr || path[0] == '\0') {
        for (int64_t t = at0; t < at1; ++t)
            for (int64_t y = ay0; y < ay1; ++y)
                std::memset(out + ((t - w.t0) * w.wy + (y - w.y0)) * w.wx + (ax0 - w.x0), 0,
                            span);
        return OK;
    }
    const size_t chunk_bytes = static_cast<size_t>(w.st * w.sy * w.sx);
    chunk.resize(chunk_bytes);
    if (!read_file(path, raw)) return UNREADABLE;
    const Status s = decode(raw.data(), raw.size(), chunk.data(), chunk_bytes, codec, fn, got);
    if (s != OK) return s;
    for (int64_t t = at0; t < at1; ++t)
        for (int64_t y = ay0; y < ay1; ++y)
            std::memcpy(out + ((t - w.t0) * w.wy + (y - w.y0)) * w.wx + (ax0 - w.x0),
                        chunk.data() + ((t - ct0) * w.sy + (y - cy0)) * w.sx + (ax0 - cx0),
                        span);
    return OK;
}

}  // namespace

extern "C" {

// Assemble the window [t0:t0+wt, y0:y0+wy, x0:x0+wx] of a C-order chunked
// uint8 (T, H, W) array into `out` (wt*wy*wx bytes). paths[c] is chunk c's
// file (NULL or "": missing, zero-filled), chunk_idx[3c:3c+3] its grid
// position, `fns` the codec table. Returns 0, or the Status of the first
// chunk that failed, with that chunk in *failed and its decoded size (-1 if
// not known) in *got.
int p2io_read_window_u8(const char** paths, const int32_t* chunk_idx, int32_t n_chunks,
                        int32_t st, int32_t sy, int32_t sx,
                        int32_t t0, int32_t y0, int32_t x0,
                        int32_t wt, int32_t wy, int32_t wx,
                        int32_t codec, const void* const* fns, uint8_t* out,
                        int32_t* failed, int64_t* got) {
    const Window w{st, sy, sx, t0, y0, x0, wt, wy, wx};
    const Codecs fn = codecs_of(fns);
    std::vector<uint8_t> raw, chunk;  // reused from chunk to chunk
    for (int32_t c = 0; c < n_chunks; ++c) {
        Status s;
        *got = -1;
        try {
            s = read_chunk(paths[c], chunk_idx + 3 * c, w, codec, fn, raw, chunk, out, got);
        } catch (...) {
            s = NO_MEMORY;
        }
        if (s != OK) {
            *failed = c;
            return s;
        }
    }
    return OK;
}

// The write path's zstd compression: ZSTD_compress of `src` at `level` into
// `dst` (dst_cap >= ZSTD_compressBound(src_n)); the compressed size, or -1.
int64_t p2io_zstd_compress(const uint8_t* src, int64_t src_n, uint8_t* dst, int64_t dst_cap,
                           int32_t level, const void* const* fns) {
    const Codecs fn = codecs_of(fns);
    if (!fn.zstd_compress || !fn.zstd_is_error) return -1;
    const size_t r = fn.zstd_compress(dst, static_cast<size_t>(dst_cap), src,
                                      static_cast<size_t>(src_n), level);
    return fn.zstd_is_error(r) ? -1 : static_cast<int64_t>(r);
}

}  // extern "C"
