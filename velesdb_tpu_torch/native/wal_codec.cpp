// Native WAL codec: batch record framing + validated scan.
//
// velesdb_tpu_torch's durability layer frames every mutation as
//   magic u8 | op u8 | id u64 | dim u32 | crc u32 | body (dim * f32)
// (little-endian, matching struct "<BBQII" in storage/vector_store.py).
// The Python loop paid ~5-10us per record on ingest and on WAL replay;
// this codec frames/scans the whole batch in one call. Counterpart of the
// reference's native storage layer (velesdb-core/src/storage/mmap.rs WAL).
//
// CRC32 is the zlib/IEEE reflected polynomial so frames are
// interchangeable with the Python implementation byte-for-byte.

#include <cstdint>
#include <cstring>

namespace {

// slicing-by-8 CRC32 (zlib/IEEE polynomial): ~4x a byte-at-a-time table
// loop, which dominated WAL recovery scans of multi-hundred-MB logs
uint32_t table[8][256];
bool table_ready = false;

void init_table() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
    table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      table[t][i] = table[0][table[t - 1][i] & 0xFFu] ^ (table[t - 1][i] >> 8);
  table_ready = true;
}

uint32_t crc32_buf(const uint8_t* p, long n) {
  if (!table_ready) init_table();
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^
        table[5][(lo >> 16) & 0xFF] ^ table[4][lo >> 24] ^
        table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
        table[1][(hi >> 16) & 0xFF] ^ table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  for (long i = 0; i < n; i++) c = table[0][(c ^ p[i]) & 0xFFu] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

constexpr long kHdr = 18;
constexpr uint8_t kMagic = 0x56;

}  // namespace

extern "C" {

// Frame n upsert records into out (caller allocates n * (18 + 4*d) bytes).
// Returns bytes written.
long wal_frame_batch(const int64_t* ids, const float* vecs, long n, long d,
                     uint8_t* out) {
  const long body = d * 4, rec = kHdr + body;
  for (long i = 0; i < n; i++) {
    uint8_t* r = out + i * rec;
    r[0] = kMagic;
    r[1] = 1;  // OP_UPSERT
    uint64_t vid = (uint64_t)ids[i];
    std::memcpy(r + 2, &vid, 8);
    uint32_t dim = (uint32_t)d;
    std::memcpy(r + 10, &dim, 4);
    const uint8_t* b = (const uint8_t*)(vecs + i * d);
    uint32_t crc = crc32_buf(b, body);
    std::memcpy(r + 14, &crc, 4);
    std::memcpy(r + 18, b, body);
  }
  return n * rec;
}

// Scan a WAL buffer: validate magic + CRC record by record, stopping at the
// first torn/corrupt record (crash-recovery semantics). Fills parallel
// arrays (caller-allocated, cap entries): id, op, body byte offset, dim.
// *consumed receives the valid prefix length. Returns the record count.
long wal_scan(const uint8_t* buf, long len, int64_t* ids, uint8_t* ops,
              long* body_off, uint32_t* dims, long cap, long* consumed) {
  long pos = 0, cnt = 0;
  while (pos + kHdr <= len && cnt < cap) {
    if (buf[pos] != kMagic) break;
    uint8_t op = buf[pos + 1];
    uint64_t vid;
    std::memcpy(&vid, buf + pos + 2, 8);
    uint32_t dim;
    std::memcpy(&dim, buf + pos + 10, 4);
    uint32_t crc;
    std::memcpy(&crc, buf + pos + 14, 4);
    long body = (long)dim * 4;
    if (pos + kHdr + body > len) break;
    if (crc32_buf(buf + pos + kHdr, body) != crc) break;
    ids[cnt] = (int64_t)vid;
    ops[cnt] = op;
    body_off[cnt] = pos + kHdr;
    dims[cnt] = dim;
    pos += kHdr + body;
    cnt++;
  }
  *consumed = pos;
  return cnt;
}

// Extract the f32 bodies of n uniform upsert records (all dim d, starting
// at buf offset 0) into out [n, d] — sequential memcpy, for bulk-load
// recovery where numpy's strided slice copy is 3-4x slower.
long wal_extract(const uint8_t* buf, long n, long d, float* out) {
  const long rec = kHdr + d * 4;
  for (long i = 0; i < n; i++)
    std::memcpy(out + i * d, buf + i * rec + kHdr, d * 4);
  return n;
}

}  // extern "C"
