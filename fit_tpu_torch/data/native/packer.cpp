// Native host-side batch packer for the latent data pipeline.
//
// The same source as fit_tpu's packer (fit_tpu/data/native/packer.cpp); the
// port builds and loads its own copy (fit_tpu_torch/data/native/__init__.py).
// A GIL-free path that reads .npy latent files, converts fp16->fp32,
// optionally h-flips in the latent domain, patchifies (C,H,W) -> (T, p*p*C)
// and zero-pads into the fixed (B, max_len, p*p*C) batch buffer with its
// validity mask: one pass, no intermediate allocations.
//
// Exposed through ctypes (a plain C interface). Built at first use with g++,
// without OpenMP: each call packs its samples in turn, and the Python side
// packs each batch as several calls on a pool of threads.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

// Minimal .npy (format v1.0/2.0) reader for C-order arrays of <f2/<f4.
struct NpyInfo {
  int ndim = 0;
  long shape[4] = {0, 0, 0, 0};
  int word = 0;  // bytes per element: 2 or 4
  long data_offset = 0;
};

bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    uint16_t h16;
    if (fread(&h16, 2, 1, f) != 1) return false;
    hlen = h16;
    info->data_offset = 10 + hlen;
  } else {
    if (fread(&hlen, 4, 1, f) != 1) return false;
    info->data_offset = 12 + hlen;
  }
  std::string header(hlen, '\0');
  if (fread(&header[0], 1, hlen, f) != hlen) return false;

  if (header.find("'fortran_order': False") == std::string::npos) return false;
  if (header.find("<f2") != std::string::npos) {
    info->word = 2;
  } else if (header.find("<f4") != std::string::npos) {
    info->word = 4;
  } else {
    return false;
  }
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return false;
  sp = header.find('(', sp);
  size_t ep = header.find(')', sp);
  if (sp == std::string::npos || ep == std::string::npos) return false;
  std::string dims = header.substr(sp + 1, ep - sp - 1);
  info->ndim = 0;
  const char* c = dims.c_str();
  while (*c && info->ndim < 4) {
    while (*c == ' ' || *c == ',') ++c;
    if (*c < '0' || *c > '9') break;
    info->shape[info->ndim++] = strtol(c, const_cast<char**>(reinterpret_cast<const char**>(&c)), 10);
  }
  return info->ndim >= 1;
}

inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while ((man & 0x400) == 0) {
        man <<= 1;
        --exp;
      }
      man &= 0x3ff;
      bits = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  memcpy(&out, &bits, 4);
  return out;
}

// Patchify one (C,H,W) fp32 latent into out (T, p*p*C) with token order
// row-major over the (H/p, W/p) grid and per-token (p, p, C) layout,
// channel fastest (parity with fit_tpu.core.geometry.patchify_np).
void patchify_into(const float* lat, int c, int h, int w, int p, float* out) {
  const int nh = h / p, nw = w / p, dtok = p * p * c;
  for (int th = 0; th < nh; ++th) {
    for (int tw = 0; tw < nw; ++tw) {
      float* tok = out + (long)(th * nw + tw) * dtok;
      for (int pi = 0; pi < p; ++pi) {
        for (int pj = 0; pj < p; ++pj) {
          const long row = (long)(th * p + pi) * w + (tw * p + pj);
          float* dst = tok + (pi * p + pj) * c;
          for (int ch = 0; ch < c; ++ch) dst[ch] = lat[(long)ch * h * w + row];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Load one .npy latent, fp16->fp32, optional h-flip, patchify+pad.
// Returns the true token count (<=0 on error). Buffers:
//   out_tokens: (max_len * dtok) floats, zero-filled here
//   out_mask:   (max_len) bytes
//   out_hw:     [h, w]
int pack_one(const char* path, int patch, int max_len, int dtok, int flip,
             float* out_tokens, unsigned char* out_mask, int* out_hw) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  if (!parse_npy_header(f, &info) || info.ndim != 3) {
    fclose(f);
    return -2;
  }
  const int c = (int)info.shape[0], h = (int)info.shape[1], w = (int)info.shape[2];
  if (patch * patch * c != dtok) {
    fclose(f);
    return -3;
  }
  const long n = (long)c * h * w;
  float* lat = new float[n];
  if (info.word == 2) {
    uint16_t* raw = new uint16_t[n];
    if (fseek(f, info.data_offset, SEEK_SET) != 0 || fread(raw, 2, n, f) != (size_t)n) {
      delete[] raw;
      delete[] lat;
      fclose(f);
      return -4;
    }
    for (long i = 0; i < n; ++i) lat[i] = half_to_float(raw[i]);
    delete[] raw;
  } else {
    if (fseek(f, info.data_offset, SEEK_SET) != 0 || fread(lat, 4, n, f) != (size_t)n) {
      delete[] lat;
      fclose(f);
      return -4;
    }
  }
  fclose(f);

  if (flip) {  // horizontal flip in the latent domain (width axis)
    for (int ch = 0; ch < c; ++ch) {
      for (int row = 0; row < h; ++row) {
        float* r = lat + ((long)ch * h + row) * w;
        for (int i = 0, j = w - 1; i < j; ++i, --j) {
          float t = r[i];
          r[i] = r[j];
          r[j] = t;
        }
      }
    }
  }

  const int t_true = (h / patch) * (w / patch);
  const int t_keep = t_true < max_len ? t_true : max_len;
  memset(out_tokens, 0, (size_t)max_len * dtok * sizeof(float));
  memset(out_mask, 0, (size_t)max_len);
  if (t_true <= max_len) {
    patchify_into(lat, c, h, w, patch, out_tokens);
  } else {
    // over-long latents: patchify fully into a scratch then truncate
    float* scratch = new float[(long)t_true * dtok];
    patchify_into(lat, c, h, w, patch, scratch);
    memcpy(out_tokens, scratch, (size_t)t_keep * dtok * sizeof(float));
    delete[] scratch;
  }
  memset(out_mask, 1, (size_t)t_keep);
  out_hw[0] = h;
  out_hw[1] = w;
  delete[] lat;
  return t_true;
}

// Bucket-mode (masked_FiT) variant: load + patchify one latent, then GATHER
// output rows by a caller-provided index map instead of identity-padding.
// gather (n_out ints): source token index per output row, or -1 for a zero
// pad row (mask 0). The caller (Python) draws the subsample permutation so
// the rng stream stays bit-identical to the pure-numpy bucket path.
int pack_one_gather(const char* path, int patch, int dtok, int flip,
                    const int* gather, int n_out, float* out_tokens,
                    unsigned char* out_mask, int* out_hw) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  if (!parse_npy_header(f, &info) || info.ndim != 3) {
    fclose(f);
    return -2;
  }
  const int c = (int)info.shape[0], h = (int)info.shape[1], w = (int)info.shape[2];
  if (patch * patch * c != dtok) {
    fclose(f);
    return -3;
  }
  const long n = (long)c * h * w;
  float* lat = new float[n];
  if (info.word == 2) {
    uint16_t* raw = new uint16_t[n];
    if (fseek(f, info.data_offset, SEEK_SET) != 0 || fread(raw, 2, n, f) != (size_t)n) {
      delete[] raw;
      delete[] lat;
      fclose(f);
      return -4;
    }
    for (long i = 0; i < n; ++i) lat[i] = half_to_float(raw[i]);
    delete[] raw;
  } else {
    if (fseek(f, info.data_offset, SEEK_SET) != 0 || fread(lat, 4, n, f) != (size_t)n) {
      delete[] lat;
      fclose(f);
      return -4;
    }
  }
  fclose(f);

  if (flip) {
    for (int ch = 0; ch < c; ++ch) {
      for (int row = 0; row < h; ++row) {
        float* r = lat + ((long)ch * h + row) * w;
        for (int i = 0, j = w - 1; i < j; ++i, --j) {
          float t = r[i];
          r[i] = r[j];
          r[j] = t;
        }
      }
    }
  }

  const int t_true = (h / patch) * (w / patch);
  float* scratch = new float[(long)t_true * dtok];
  patchify_into(lat, c, h, w, patch, scratch);
  delete[] lat;
  for (int j = 0; j < n_out; ++j) {
    const int g = gather[j];
    float* dst = out_tokens + (long)j * dtok;
    if (g >= 0 && g < t_true) {
      memcpy(dst, scratch + (long)g * dtok, (size_t)dtok * sizeof(float));
      out_mask[j] = 1;
    } else {
      memset(dst, 0, (size_t)dtok * sizeof(float));
      out_mask[j] = 0;
    }
  }
  delete[] scratch;
  out_hw[0] = h;
  out_hw[1] = w;
  return t_true;
}

// Pack a run of samples. flips: per-sample 0/1.
// Returns 0 on success; on error the index of the first failing sample is
// encoded as -(i+1) and lengths[i] holds its pack_one error code.
int pack_batch(const char** paths, const int* flips, int n, int patch,
               int max_len, int dtok, float* out_tokens,
               unsigned char* out_mask, int* out_hw, int* lengths) {
  int err = 0;
  for (int i = 0; i < n; ++i) {
    int r = pack_one(paths[i], patch, max_len, dtok, flips[i],
                     out_tokens + (long)i * max_len * dtok,
                     out_mask + (long)i * max_len, out_hw + 2 * i);
    lengths[i] = r;
    if (r <= 0 && err == 0) err = -(i + 1);
  }
  return err;
}

// Batched gather variant (bucket mode): gather is (n, n_out) row-major.
int pack_batch_gather(const char** paths, const int* flips, const int* gather,
                      int n, int n_out, int patch, int dtok,
                      float* out_tokens, unsigned char* out_mask, int* out_hw,
                      int* lengths) {
  int err = 0;
  for (int i = 0; i < n; ++i) {
    int r = pack_one_gather(paths[i], patch, dtok, flips[i],
                            gather + (long)i * n_out, n_out,
                            out_tokens + (long)i * n_out * dtok,
                            out_mask + (long)i * n_out, out_hw + 2 * i);
    lengths[i] = r;
    if (r <= 0 && err == 0) err = -(i + 1);
  }
  return err;
}

}  // extern "C"
