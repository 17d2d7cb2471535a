// Byte-exact `.yak` dump support: a host-side simulator of the
// reference's insertion protocol so that `count -o` output can be
// byte-identical to reference yak's, INCLUDING the within-shard khashl
// slot order (the one piece of the dump format that is an artifact of
// insertion order rather than table content; see io/yakfmt.py).
//
// Semantics reproduced (re-derived from the reference, not transcribed):
//   - k-mer stream:    count.c:28-60   (canonical strand-min encode +
//                      yak_hash64 for k<32; 4-plane yak_hash_long for
//                      k>=32; N resets; records shorter than k skipped)
//   - shard split:     count.c:17-26   (low `pre` bits of the hash)
//   - insert protocol: htab.c:51-78    (bloom-gated create, in-place
//                      saturating count increment in the key's low
//                      YAK_COUNTER_BITS)
//   - blocked bloom:   bbf.c:25-42     (512-bit cache-line blocks,
//                      double hashing, h2 forced odd-ish)
//   - khashl layout:   khashl.h:96,152-221 (Fibonacci h2b on the
//                      32-bit-truncated key>>10, linear probing, resize
//                      to the next power of two at 3/4 load with the
//                      in-slot-order kick-out rehash)
//   - two-pass -b:     main.c:53-60    (clear = mask counts in place;
//                      pass 2 increments existing keys only; shrink =
//                      re-put survivors in slot order into a fresh
//                      table pre-sized to the old kh_size)
//
// Key order-invariance facts that make a one-stream simulation exact
// (verified empirically: reference dumps are byte-identical across -t1/
// -t4 and different -K):
//   * per shard, the insert sequence is the global stream order of that
//     shard's k-mers regardless of chunking/threading (per-shard block
//     buffers are appended in read order; blocks complete in order);
//   * duplicate puts never mutate the layout, so the exact put at which
//     the 3/4-load resize fires does not change the resulting layout.
//
// The TPU table remains the source of truth for counts; the Python
// caller cross-checks the simulator's (hash, count) multiset against
// the device table before trusting the byte layout (io/exactdump.py).

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

constexpr int COUNTER_BITS = 10;                 // yak.h:9
constexpr uint64_t MAX_COUNT = (1u << COUNTER_BITS) - 1;
constexpr int BLK_SHIFT = 9;                     // yak.h:13 (64-byte block)
constexpr uint32_t BLK_MASK = (1u << BLK_SHIFT) - 1;

inline uint64_t hash64(uint64_t key, uint64_t mask) {  // yak-priv.h:11
  key = (~key + (key << 21)) & mask;
  key = key ^ key >> 24;
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ key >> 14;
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ key >> 28;
  key = (key + (key << 31)) & mask;
  return key;
}

inline uint64_t hash64_64(uint64_t key) {        // yak-priv.h:23
  key = ~key + (key << 21);
  key = key ^ key >> 24;
  key = (key + (key << 3)) + (key << 8);
  key = key ^ key >> 14;
  key = (key + (key << 2)) + (key << 4);
  key = key ^ key >> 28;
  key = key + (key << 31);
  return key;
}

inline uint64_t hash_long(const uint64_t x[4]) { // yak-priv.h:35
  int j = x[1] < x[3] ? 0 : 1;
  return hash64_64(x[j << 1 | 0]) + hash64_64(x[j << 1 | 1]);
}

// khashl.h:96 — the whole layout hangs off this Fibonacci bucketing of
// the LOW 32 BITS of (key >> COUNTER_BITS).
inline uint32_t h2b(uint32_t hash, uint32_t bits) {
  return (uint32_t)(hash * 2654435769u) >> (32 - bits);
}

inline uint32_t key_bucket_hash(uint64_t key) {
  return (uint32_t)(key >> COUNTER_BITS);
}

// One khashl set (yak_ht_t): open addressing, linear probe, used bitmap.
struct KhTable {
  uint32_t bits = 0;
  uint32_t count = 0;
  std::vector<uint32_t> used;   // bitmap, empty until first resize
  std::vector<uint64_t> keys;

  bool allocated() const { return !keys.empty(); }
  uint32_t capacity() const { return allocated() ? 1u << bits : 0; }
  bool is_used(uint32_t i) const { return used[i >> 5] >> (i & 31u) & 1u; }
  void set_used(uint32_t i) { used[i >> 5] |= 1u << (i & 31u); }
  void set_unused(uint32_t i) { used[i >> 5] &= ~(1u << (i & 31u)); }
  static size_t fsize(uint32_t m) { return m < 32 ? 1 : m >> 5; }

  // khashl.h:152 resize: kick-out rehash walking old slots in order.
  void resize(uint32_t new_n_buckets) {
    uint32_t j = 0, x = new_n_buckets;
    while ((x >>= 1) != 0) ++j;
    if (new_n_buckets & (new_n_buckets - 1)) ++j;
    uint32_t new_bits = j > 2 ? j : 2;
    new_n_buckets = 1u << new_bits;
    if (count > (new_n_buckets >> 1) + (new_n_buckets >> 2)) return;
    std::vector<uint32_t> new_used(fsize(new_n_buckets), 0);
    uint32_t n_buckets = allocated() ? 1u << bits : 0;
    if (n_buckets < new_n_buckets) keys.resize(new_n_buckets);
    uint32_t new_mask = new_n_buckets - 1;
    for (j = 0; j != n_buckets; ++j) {
      if (!is_used(j)) continue;
      uint64_t key = keys[j];
      set_unused(j);
      for (;;) {  // kick-out: old-table occupants of the target slot are
                  // displaced and re-seated in turn (khashl.h:170-184)
        uint32_t i = h2b(key_bucket_hash(key), new_bits);
        while (new_used[i >> 5] >> (i & 31u) & 1u) i = (i + 1) & new_mask;
        new_used[i >> 5] |= 1u << (i & 31u);
        if (i < n_buckets && is_used(i)) {
          std::swap(keys[i], key);
          set_unused(i);
        } else {
          keys[i] = key;
          break;
        }
      }
    }
    if (n_buckets > new_n_buckets) keys.resize(new_n_buckets);
    used.swap(new_used);
    bits = new_bits;
  }

  // khashl.h:198 put. Returns slot; *absent=1 on fresh insert.
  uint32_t put(uint64_t key, int* absent) {
    uint32_t n_buckets = allocated() ? 1u << bits : 0;
    *absent = -1;
    if (count >= (n_buckets >> 1) + (n_buckets >> 2)) {
      resize(n_buckets + 1u);
      n_buckets = 1u << bits;
    }
    uint32_t mask = n_buckets - 1;
    uint32_t i = h2b(key_bucket_hash(key), bits), last = i;
    while (is_used(i) &&
           (keys[i] >> COUNTER_BITS) != (key >> COUNTER_BITS)) {
      i = (i + 1u) & mask;
      if (i == last) break;
    }
    if (!is_used(i)) {
      keys[i] = key;
      set_used(i);
      ++count;
      *absent = 1;
    } else {
      *absent = 0;
    }
    return i;
  }

  // khashl.h:137 get; returns capacity() when missing.
  uint32_t get(uint64_t key) const {
    if (!allocated()) return 0;
    uint32_t n_buckets = 1u << bits, mask = n_buckets - 1;
    uint32_t i = h2b(key_bucket_hash(key), bits), last = i;
    while (is_used(i) &&
           (keys[i] >> COUNTER_BITS) != (key >> COUNTER_BITS)) {
      i = (i + 1u) & mask;
      if (i == last) return n_buckets;
    }
    return is_used(i) ? i : n_buckets;
  }
};

// bbf.c blocked Bloom filter (bit layout identical to ops/bloom.py).
struct BloomShard {
  int n_shift = 0, n_hashes = 0;
  std::vector<uint8_t> b;
  void init(int shift, int hashes) {
    n_shift = shift;
    n_hashes = hashes;
    b.assign(size_t(1) << (shift - 3), 0);
  }
  int insert(uint64_t hash) {  // bbf.c:25
    int x = n_shift - BLK_SHIFT;
    uint64_t y = hash & ((1ull << x) - 1);
    uint32_t h1 = (uint32_t)(hash >> x) & BLK_MASK;
    uint32_t h2 = (uint32_t)(hash >> n_shift) & BLK_MASK;
    uint8_t* p = &b[y << (BLK_SHIFT - 3)];
    if ((h2 & 31) == 0) h2 = (h2 + 1) & BLK_MASK;
    int cnt = 0;
    uint32_t z = h1;
    for (int i = 0; i < n_hashes; z = (z + h2) & BLK_MASK) {
      uint8_t u = uint8_t(1u << (z & 7));
      cnt += !!(p[z >> 3] & u);
      p[z >> 3] |= u;
      ++i;
    }
    return cnt;
  }
};

struct Layout {
  int k, pre, bf_shift, bf_n_hash;
  std::vector<KhTable> shards;
  std::vector<BloomShard> bloom;  // empty when bf_shift == 0
  int64_t tot = 0;

  // htab.c:61-75 per-k-mer insert (list loop flattened to one stream).
  void insert_hash(uint64_t y, int create_new) {
    uint32_t s = (uint32_t)(y & ((1u << pre) - 1));
    uint64_t x = y >> pre;
    KhTable& g = shards[s];
    if (create_new) {
      int ins = 1;
      if (!bloom.empty()) ins = bloom[s].insert(x) == bf_n_hash;
      if (ins) {
        int absent;
        uint32_t kk = g.put(x << COUNTER_BITS, &absent);
        if (absent) ++tot;
        if ((g.keys[kk] & MAX_COUNT) < MAX_COUNT) ++g.keys[kk];
      }
    } else {
      uint32_t kk = g.get(x << COUNTER_BITS);
      if (kk != g.capacity() && (g.keys[kk] & MAX_COUNT) < MAX_COUNT)
        ++g.keys[kk];
    }
  }

  // count.c:28-60 per-record k-mer enumeration.
  void feed_seq(const char* seq, long len, int create_new,
                const int8_t* nt4) {
    if (len < k) return;  // count.c:94
    if (k < 32) {
      uint64_t x0 = 0, x1 = 0, mask = (1ull << (2 * k)) - 1;
      int shift = (k - 1) * 2, l = 0;
      for (long i = 0; i < len; ++i) {
        int c = nt4[(uint8_t)seq[i]];
        if (c < 4) {
          x0 = (x0 << 2 | (uint64_t)c) & mask;
          x1 = x1 >> 2 | (uint64_t)(3 - c) << shift;
          if (++l >= k)
            insert_hash(hash64(x0 < x1 ? x0 : x1, mask), create_new);
        } else {
          l = 0, x0 = x1 = 0;
        }
      }
    } else {
      uint64_t x[4] = {0, 0, 0, 0}, mask = (1ull << k) - 1;
      int shift = k - 1, l = 0;
      for (long i = 0; i < len; ++i) {
        int c = nt4[(uint8_t)seq[i]];
        if (c < 4) {
          x[0] = (x[0] << 1 | (uint64_t)(c & 1)) & mask;
          x[1] = (x[1] << 1 | (uint64_t)(c >> 1)) & mask;
          x[2] = x[2] >> 1 | (uint64_t)(1 - (c & 1)) << shift;
          x[3] = x[3] >> 1 | (uint64_t)(1 - (c >> 1)) << shift;
          if (++l >= k) insert_hash(hash_long(x), create_new);
        } else {
          l = 0, x[0] = x[1] = x[2] = x[3] = 0;
        }
      }
    }
  }
};

// Minimal gz FASTA/FASTQ record reader (independent of fastx.cpp's
// chunk pipeline — the simulator wants whole records in stream order).
struct SeqReader {
  gzFile fp = nullptr;
  std::vector<char> buf;
  size_t pos = 0, len = 0;
  bool eof = false;

  bool open(const char* path) {
    fp = (path && std::strcmp(path, "-")) ? gzopen(path, "r")
                                          : gzdopen(0, "r");
    if (fp) gzbuffer(fp, 1 << 20);
    buf.resize(1 << 20);
    return fp != nullptr;
  }
  int peek() {
    if (pos == len && !fill()) return -1;
    return (uint8_t)buf[pos];
  }
  bool fill() {
    if (eof) return false;
    int n = gzread(fp, buf.data(), (unsigned)buf.size());
    if (n <= 0) {
      eof = true;
      return false;
    }
    pos = 0, len = (size_t)n;
    return true;
  }
  // append one line (sans terminator) to out; false on EOF-before-data
  bool getline(std::string& out) {
    out.clear();
    bool any = false;
    for (;;) {
      if (pos == len && !fill()) return any;
      size_t i = pos;
      while (i < len && buf[i] != '\n') ++i;
      out.append(&buf[pos], i - pos);
      any = true;
      if (i < len) {
        pos = i + 1;
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return true;
      }
      pos = len;
    }
  }
  void close() {
    if (fp) gzclose(fp);
    fp = nullptr;
  }
};

struct Handle {
  Layout layout;
  int8_t nt4[256];
};

}  // namespace

extern "C" {

void* ykl_create(int k, int pre, int bf_shift, int bf_n_hash) {
  if (pre < COUNTER_BITS || k < 1 || k >= 64) return nullptr;
  Handle* h = new Handle();
  Layout& L = h->layout;
  L.k = k, L.pre = pre, L.bf_shift = bf_shift, L.bf_n_hash = bf_n_hash;
  L.shards.resize(size_t(1) << pre);
  // yak_ch_init: per-shard BF of 2^(shift-pre) bits — but yak_bf_init
  // returns NULL (counting runs ungated) unless the per-shard filter
  // holds >= one 512-bit block and <= 2^64 bits (bbf.c:9)
  if (bf_shift > pre && bf_shift - pre >= BLK_SHIFT
      && (bf_shift - pre) + BLK_SHIFT <= 64) {
    L.bloom.resize(size_t(1) << pre);
    for (auto& b : L.bloom) b.init(bf_shift - pre, bf_n_hash);
  }
  std::memset(h->nt4, 4, sizeof(h->nt4));  // seq_nt4_table
  const char* acgt = "ACGT";
  for (int i = 0; i < 4; ++i) {
    h->nt4[(uint8_t)acgt[i]] = (int8_t)i;
    h->nt4[(uint8_t)std::tolower(acgt[i])] = (int8_t)i;
  }
  return h;
}

// Stream one FASTA/FASTQ(.gz) file through the insert protocol.
// create_new=1: pass-1 (bloom-gated if configured); 0: pass-2 increments.
// Returns number of records fed, or -1 on open failure / bad format.
long ykl_count_file(void* hp, const char* path, int create_new) {
  Handle* h = (Handle*)hp;
  SeqReader r;
  if (!r.open(path)) return -1;
  std::string line, seq;
  long n_rec = 0;
  int c = r.peek();
  while (c == '>' || c == '@') {
    bool fastq = c == '@';
    r.getline(line);  // header
    seq.clear();
    for (;;) {  // sequence lines until next record / '+' / EOF
      int p = r.peek();
      if (p < 0 || p == '>' || p == '@' || (fastq && p == '+')) break;
      if (!r.getline(line)) break;
      seq += line;
    }
    if (fastq && r.peek() == '+') {
      r.getline(line);  // "+" line
      size_t q = 0;     // quality: exactly seq.size() chars across lines
      while (q < seq.size() && r.getline(line)) q += line.size();
    }
    h->layout.feed_seq(seq.data(), (long)seq.size(), create_new, h->nt4);
    ++n_rec;
    c = r.peek();
  }
  r.close();
  return n_rec;
}

// main.c:54-55 between the two -b passes: drop BFs, zero count bits
// in place (worker_clear, htab.c:116-125 — layout untouched).
void ykl_clear_counts(void* hp) {
  Handle* h = (Handle*)hp;
  h->layout.bloom.clear();
  h->layout.bloom.shrink_to_fit();
  uint64_t mask = ~0ull >> COUNTER_BITS << COUNTER_BITS;
  for (auto& g : h->layout.shards) {
    uint32_t end = g.capacity();
    for (uint32_t i = 0; i < end; ++i)
      if (g.is_used(i)) g.keys[i] &= mask;
  }
}

// htab.c:180-207 shrink: per shard, fresh table resized to kh_size, then
// re-put survivors (min<=count<=max) walking the OLD slots in order.
void ykl_shrink(void* hp, int mn, int mx) {
  Handle* h = (Handle*)hp;
  if (!(mx >= mn && mx <= (int)MAX_COUNT)) mx = (int)MAX_COUNT;
  h->layout.tot = 0;
  for (auto& g : h->layout.shards) {
    KhTable f;
    f.resize(g.count);
    uint32_t end = g.capacity();
    for (uint32_t i = 0; i < end; ++i) {
      if (!g.is_used(i)) continue;
      int c = (int)(g.keys[i] & MAX_COUNT);
      if (c >= mn && c <= mx) {
        int absent;
        f.put(g.keys[i], &absent);
      }
    }
    g = std::move(f);
    h->layout.tot += g.count;
  }
}

int64_t ykl_tot(void* hp) {
  Handle* h = (Handle*)hp;
  int64_t t = 0;
  for (auto& g : h->layout.shards) t += g.count;
  return t;
}

uint32_t ykl_shard_cap(void* hp, int s) {
  return ((Handle*)hp)->layout.shards[s].capacity();
}

uint32_t ykl_shard_size(void* hp, int s) {
  return ((Handle*)hp)->layout.shards[s].count;
}

// Write the shard's in-table keys in slot order (the dump order,
// htab.c:373-394) into out[size]; returns the number written.
uint32_t ykl_shard_keys(void* hp, int s, uint64_t* out) {
  KhTable& g = ((Handle*)hp)->layout.shards[s];
  uint32_t n = 0, end = g.capacity();
  for (uint32_t i = 0; i < end; ++i)
    if (g.is_used(i)) out[n++] = g.keys[i];
  return n;
}

void ykl_destroy(void* hp) { delete (Handle*)hp; }

}  // extern "C"
