// Native ingest runtime: streaming FASTA/FASTQ parser + 2-bit encoder +
// fixed-shape chunk packer with a background pipeline thread.
//
// This is the TPU framework's equivalent of the reference's C front-end
// (kseq.h record parsing, bseq.c:33-58 chunk batching) and of the
// kt_pipeline read-stage overlap (kthread.c:74-159): a producer thread
// parses and packs the NEXT device chunk while the consumer (JAX) runs
// extract/insert on the current one, through a bounded chunk queue.
//
// Packing semantics are EXACTLY those of yak_tpu/io/pack.py (the pure-
// Python fallback): all sequences concatenate into one flat uint8 code
// buffer of fixed size, separated by one N cell (code 4); sequences that
// straddle a chunk boundary are split with a (k-1)-base halo so every
// k-mer window is produced exactly once; optional per-position metadata
// (sequence id, base offset) for the lookup workloads.  Differential
// tests in tests/test_native.py assert chunk-stream equality against the
// Python packer.
//
// Build: g++ -O3 -shared -fPIC -o libyakfastx.so fastx.cpp -lz -lpthread
// (done automatically by yak_tpu/native/__init__.py).

#include <zlib.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <unistd.h>

namespace {

// A..Z encode table: A/a=0 C/c=1 G/g=2 T/t=3, everything else 4
// (misc.c:4-21 semantics).
struct Nt4 {
    uint8_t t[256];
    Nt4() {
        memset(t, 4, sizeof(t));
        t[(int)'A'] = t[(int)'a'] = 0;
        t[(int)'C'] = t[(int)'c'] = 1;
        t[(int)'G'] = t[(int)'g'] = 2;
        t[(int)'T'] = t[(int)'t'] = 3;
    }
};
const Nt4 NT4;

int64_t now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

// Nanoseconds a reader spent, counted only when it was opened with
// stats on (yx_open's last argument; yx_stats reads them): the producer
// in gzread (input), in pack_planes (pack) and blocked on a full queue
// (full), the consumer blocked on an empty one (empty), and the
// producer thread's start and end.
struct Stats {
    std::atomic<int64_t> input{0}, pack{0}, full{0}, empty{0};
    std::atomic<int64_t> start{0}, end{0};
};

// Adds the nanoseconds from its construction to its destruction to
// `*into`; does nothing, reading no clock, when `into` is null.
class Timed {
  public:
    explicit Timed(std::atomic<int64_t> *into)
        : into_(into), t0_(into ? now_ns() : 0) {}
    ~Timed() {
        if (into_) into_->fetch_add(now_ns() - t0_);
    }

  private:
    std::atomic<int64_t> *into_;
    int64_t t0_;
};

struct Chunk {
    std::vector<uint8_t> codes;    // [chunk_size], pad = 4
    std::vector<int32_t> seq_id;   // [chunk_size], -1 = separator/pad
    std::vector<int32_t> pos;      // [chunk_size]
    // LSB-first packed bit planes (io/pack.pack_planes layout): filled
    // by the producer thread at emit time so the consumer's host side
    // never touches the codes on the hot paths.
    std::vector<uint32_t> plo, phi, pnn;
    long n_bases = 0;
    // sequences appearing in this chunk (incl. halo continuations),
    // ascending gid; names '\n'-joined in the same order.  Per entry,
    // the record's single contiguous PIECE in this chunk: first cell,
    // source base offset of that cell, and base count (0 if the record
    // was registered at the chunk edge with no room for a window).
    std::vector<int64_t> meta_gid;
    std::vector<int64_t> meta_len;
    std::vector<int64_t> meta_start;
    std::vector<int64_t> meta_off0;
    std::vector<int64_t> meta_take;
    std::string meta_names;

    explicit Chunk(long cs, int meta_level)
        : codes(cs, 4),
          seq_id(meta_level >= 2 ? cs : 0, -1),
          pos(meta_level >= 2 ? cs : 0, 0) {}
};

// Buffered line reader over a gzFile (gz* reads plain files too).
class LineReader {
  public:
    LineReader(gzFile f, std::atomic<int64_t> *input_ns)
        : f_(f), buf_(1 << 20), input_ns_(input_ns) {}

    // Reads one line (without trailing \r?\n) into `out`; false at EOF
    // when nothing was read.
    bool getline(std::string &out) {
        out.clear();
        return getline_append(out);
    }

    // Appends one line to `dst` WITHOUT clearing (the parser's sequence
    // accumulator path: gz buffer -> dst directly, no intermediate line
    // string).  Returns false at EOF when nothing was appended.
    bool getline_append(std::string &dst) {
        const size_t mark = dst.size();
        for (;;) {
            if (p_ == n_) {
                n_ = fill();
                p_ = 0;
                if (n_ <= 0) return dst.size() > mark;
            }
            char *nl = (char *)memchr(buf_.data() + p_, '\n', n_ - p_);
            if (nl) {
                long len = nl - (buf_.data() + p_);
                dst.append(buf_.data() + p_, len);
                p_ += len + 1;
                if (dst.size() > mark && dst.back() == '\r')
                    dst.pop_back();
                return true;
            }
            dst.append(buf_.data() + p_, n_ - p_);
            p_ = n_;
        }
    }

    // First char of the next line without consuming it; -1 at EOF.
    int peek() {
        if (p_ == n_) {
            n_ = fill();
            p_ = 0;
            if (n_ <= 0) return -1;
        }
        return (unsigned char)buf_[p_];
    }

  private:
    long fill() {
        Timed t(input_ns_);
        return gzread(f_, buf_.data(), (unsigned)buf_.size());
    }

    gzFile f_;
    std::vector<char> buf_;
    std::atomic<int64_t> *input_ns_;
    long p_ = 0, n_ = 0;
};

struct Record {
    std::string name;
    std::string seq;  // raw bases (encoded on pack)
};

// FASTA/FASTQ record parser, same tolerance as io/fasta.py: seeks to the
// next '>'/'@' header, multi-line sequences, multi-line FASTQ quality
// read until len(qual) >= len(seq).
class FastxParser {
  public:
    FastxParser(gzFile f, std::atomic<int64_t> *input_ns)
        : lr_(f, input_ns) {}

    bool next(Record &rec) {
        std::string &line = line_;   // member: capacity reused per record
        if (!pending_.empty()) {
            line.swap(pending_);
            pending_.clear();  // line_ is reused; drop its old contents
        } else {
            for (;;) {
                if (!lr_.getline(line)) return false;
                if (!line.empty() && (line[0] == '>' || line[0] == '@'))
                    break;
            }
        }
        bool is_fq = line[0] == '@';
        size_t sp = line.find_first_of(" \t");
        rec.name.assign(line, 1, (sp == std::string::npos ? line.size()
                                                          : sp) - 1);
        rec.seq.clear();
        // Sequence lines append straight from the gz buffer into
        // rec.seq (one copy, no intermediate line string); peek() on
        // the first byte classifies header/'+' lines before consuming.
        if (!is_fq) {
            for (;;) {
                int c0 = lr_.peek();
                if (c0 < 0) break;
                if (c0 == '>' || c0 == '@') {
                    lr_.getline(pending_);
                    break;
                }
                size_t mark = rec.seq.size();
                lr_.getline_append(rec.seq);
                strip_region(rec.seq, mark);
            }
        } else {
            for (;;) {
                int c0 = lr_.peek();
                if (c0 < 0) break;
                if (c0 == '+') {
                    lr_.getline(line);
                    break;
                }
                size_t mark = rec.seq.size();
                lr_.getline_append(rec.seq);
                strip_region(rec.seq, mark);
            }
            size_t qlen = 0;
            while (qlen < rec.seq.size()) {
                if (!lr_.getline(line)) break;
                qlen += stripped_len(line);
            }
        }
        return true;
    }

  private:
    // Trim whitespace at both ends of the just-appended region
    // [mark, size) — same effect as the old per-line strip_append
    // (lines already lack \r\n; interior whitespace is untouched in
    // both versions since trimming is end-anchored per line).
    static void strip_region(std::string &dst, size_t mark) {
        size_t e = dst.size();
        while (e > mark && isspace((unsigned char)dst[e - 1])) e--;
        dst.resize(e);
        size_t b = mark;
        while (b < e && isspace((unsigned char)dst[b])) b++;
        if (b > mark) dst.erase(mark, b - mark);
    }
    static size_t stripped_len(const std::string &line) {
        size_t b = 0, e = line.size();
        while (b < e && isspace((unsigned char)line[b])) b++;
        while (e > b && isspace((unsigned char)line[e - 1])) e--;
        return e - b;
    }
    LineReader lr_;
    std::string pending_, line_;
};

class Stream {
  public:
    Stream(const char *path, long chunk_size, int k, long min_len,
           int meta_level, int n_buf, bool stats)
        : chunk_size_(chunk_size), k_(k), min_len_(min_len),
          meta_level_(meta_level), max_queue_(n_buf < 1 ? 1 : n_buf),
          stats_on_(stats) {
        if (!path || !strcmp(path, "-"))
            f_ = gzdopen(dup(0), "r");
        else
            f_ = gzopen(path, "r");
        if (f_) {
            gzbuffer(f_, 1 << 20);
            worker_ = std::thread([this] { produce(); });
            ok_ = true;
        }
    }

    ~Stream() {
        {
            std::lock_guard<std::mutex> g(mu_);
            stop_ = true;
        }
        cv_space_.notify_all();
        if (worker_.joinable()) worker_.join();
        if (f_) gzclose(f_);
    }

    bool ok() const { return ok_; }

    // Pop the next chunk; nullptr at end of stream.
    std::unique_ptr<Chunk> pop() {
        std::unique_lock<std::mutex> lk(mu_);
        {
            Timed t(stat(stats_.empty));
            cv_data_.wait(lk, [this] { return !queue_.empty() || done_; });
        }
        if (queue_.empty()) return nullptr;
        auto c = std::move(queue_.front());
        queue_.pop_front();
        cv_space_.notify_one();
        return c;
    }

    int64_t n_seq() const { return n_seq_.load(); }

    // out[0..4]: input, pack, full, empty and the producer's lifetime,
    // ns (the lifetime so far while it runs); zeros with stats off.
    void stats(int64_t *out) const {
        const int64_t start = stats_.start.load(), end = stats_.end.load();
        out[0] = stats_.input.load();
        out[1] = stats_.pack.load();
        out[2] = stats_.full.load();
        out[3] = stats_.empty.load();
        out[4] = start ? (end ? end : now_ns()) - start : 0;
    }

  private:
    std::atomic<int64_t> *stat(std::atomic<int64_t> &counter) {
        return stats_on_ ? &counter : nullptr;
    }

    // Pack the chunk's bit planes (identical layout to
    // io/pack.pack_planes: one spare word past the end, pad bases = N).
    // Hot path: 8 bases per u64 via the multiply-gather trick —
    // ((x & 0x0101..01) * 0x0102040810204080) >> 56 packs the 8 byte
    // LSBs into 8 consecutive bits (carry-free: the shifted partial
    // products land on distinct bit positions).
    void pack_planes(Chunk &c) const {
        const long L = (long)c.codes.size();
        const long W = (L + 31) / 32 + 1;
        c.plo.assign(W, 0);
        c.phi.assign(W, 0);
        c.pnn.assign(W, 0);
        const uint8_t *s = c.codes.data();
        constexpr uint64_t M1 = 0x0101010101010101ull;
        constexpr uint64_t MG = 0x0102040810204080ull;
        const long full = L / 32;          // whole 32-base words
        for (long q = 0; q < full; q++) {
            uint64_t x[4];
            memcpy(x, s + q * 32, 32);
            uint32_t lo = 0, hi = 0, nn = 0;
            for (int j = 0; j < 4; j++) {
                lo |= (uint32_t)(((x[j] & M1) * MG) >> 56) << (8 * j);
                hi |= (uint32_t)((((x[j] >> 1) & M1) * MG) >> 56)
                      << (8 * j);
                nn |= (uint32_t)((((x[j] >> 2) & M1) * MG) >> 56)
                      << (8 * j);
            }
            c.plo[q] = lo;
            c.phi[q] = hi;
            c.pnn[q] = nn;
        }
        if (L % 32) {                      // ragged tail word
            const long base = full * 32;
            const long m = L - base;
            uint32_t lo = 0, hi = 0, nn = 0;
            for (long r = 0; r < m; r++) {
                const uint32_t v = s[base + r];
                lo |= (v & 1u) << r;
                hi |= ((v >> 1) & 1u) << r;
                nn |= (v >> 2) << r;
            }
            nn |= ~0u << m;                // pad bases beyond L are N
            c.plo[full] = lo;
            c.phi[full] = hi;
            c.pnn[full] = nn;
        }
        for (long q = (L + 31) / 32; q < W; q++) c.pnn[q] = ~0u;
    }

    void emit(std::unique_ptr<Chunk> c) {
        {
            Timed t(stat(stats_.pack));
            pack_planes(*c);
        }
        std::unique_lock<std::mutex> lk(mu_);
        {
            Timed t(stat(stats_.full));
            cv_space_.wait(
                lk, [this] { return queue_.size() < max_queue_ || stop_; });
        }
        if (stop_) return;
        queue_.push_back(std::move(c));
        cv_data_.notify_one();
    }

    void add_meta(Chunk &c, int64_t gid, const Record &rec, long w,
                  long off) {
        if (meta_level_ < 1) return;
        c.meta_gid.push_back(gid);
        c.meta_len.push_back((int64_t)rec.seq.size());
        c.meta_start.push_back(w);
        c.meta_off0.push_back(off);
        c.meta_take.push_back(0);   // set at take time
        c.meta_names.append(rec.name);
        c.meta_names.push_back('\n');
    }

    void produce() {
        if (stats_on_) stats_.start = now_ns();
        FastxParser parser(f_, stat(stats_.input));
        auto cur = std::make_unique<Chunk>(chunk_size_, meta_level_);
        long w = 0;
        Record rec;
        int64_t gid = 0;
        while (!stop_ && parser.next(rec)) {
            if ((long)rec.seq.size() < min_len_) continue;
            int64_t g = gid++;
            n_seq_.fetch_add(1);
            const long L = (long)rec.seq.size();
            long off = 0;
            add_meta(*cur, g, rec, w, off);
            while (off < L) {
                if (chunk_size_ - w < k_) {  // no room for a single window
                    emit(std::move(cur));
                    if (stop_) return;
                    cur = std::make_unique<Chunk>(chunk_size_, meta_level_);
                    w = 0;
                    add_meta(*cur, g, rec, w, off);
                }
                long take = std::min(L - off, chunk_size_ - w);
                const char *src = rec.seq.data() + off;
                uint8_t *dst = cur->codes.data() + w;
                for (long i = 0; i < take; i++)
                    dst[i] = NT4.t[(unsigned char)src[i]];
                if (meta_level_ >= 1 && !cur->meta_take.empty()) {
                    // the piece actually begins here (a no-room emit may
                    // have moved w since registration)
                    cur->meta_start.back() = w;
                    cur->meta_off0.back() = off;
                    cur->meta_take.back() = take;
                }
                if (meta_level_ >= 2) {
                    int32_t *sid = cur->seq_id.data() + w;
                    int32_t *pos = cur->pos.data() + w;
                    for (long i = 0; i < take; i++) {
                        sid[i] = (int32_t)g;
                        pos[i] = (int32_t)(off + i);
                    }
                }
                cur->n_bases += take;
                w += take;
                off += take;
                if (off < L) {  // halo: continuation re-reads k-1 bases
                    off -= k_ - 1;
                    emit(std::move(cur));
                    if (stop_) return;
                    cur = std::make_unique<Chunk>(chunk_size_, meta_level_);
                    w = 0;
                    add_meta(*cur, g, rec, w, off);
                }
            }
            w += 1;  // one separator cell (already code 4)
        }
        if (cur->n_bases > 0 && !stop_) emit(std::move(cur));
        if (stats_on_) stats_.end = now_ns();
        {
            std::lock_guard<std::mutex> g(mu_);
            done_ = true;
        }
        cv_data_.notify_all();
    }

    const long chunk_size_;
    const int k_;
    const long min_len_;
    const int meta_level_;
    const size_t max_queue_;
    const bool stats_on_;
    Stats stats_;

    gzFile f_ = nullptr;
    bool ok_ = false;
    std::thread worker_;
    std::mutex mu_;
    std::condition_variable cv_data_, cv_space_;
    std::deque<std::unique_ptr<Chunk>> queue_;
    bool done_ = false, stop_ = false;
    std::atomic<int64_t> n_seq_{0};
};

struct Handle {
    std::unique_ptr<Stream> stream;
    std::unique_ptr<Chunk> current;  // owned until the next yx_next
};

}  // namespace

extern "C" {

void *yx_open(const char *path, long chunk_size, int k, long min_len,
              int meta_level, int n_buf, int stats) {
    auto h = std::make_unique<Handle>();
    h->stream = std::make_unique<Stream>(path, chunk_size, k, min_len,
                                         meta_level, n_buf, stats != 0);
    if (!h->stream->ok()) return nullptr;
    return h.release();
}

// Advance to the next chunk.  Returns n_bases (>=0) or -1 at EOF.
long yx_next(void *hp) {
    auto *h = (Handle *)hp;
    h->current = h->stream->pop();
    if (!h->current) return -1;
    return h->current->n_bases;
}

const uint8_t *yx_codes(void *hp) { return ((Handle *)hp)->current->codes.data(); }
long yx_plane_words(void *hp) { return (long)((Handle *)hp)->current->plo.size(); }
const uint32_t *yx_plo(void *hp) { return ((Handle *)hp)->current->plo.data(); }
const uint32_t *yx_phi(void *hp) { return ((Handle *)hp)->current->phi.data(); }
const uint32_t *yx_pnn(void *hp) { return ((Handle *)hp)->current->pnn.data(); }
const int32_t *yx_seq_id(void *hp) { return ((Handle *)hp)->current->seq_id.data(); }
const int32_t *yx_pos(void *hp) { return ((Handle *)hp)->current->pos.data(); }

long yx_meta_n(void *hp) { return (long)((Handle *)hp)->current->meta_gid.size(); }

void yx_meta_fill(void *hp, int64_t *gids, int64_t *lens, int64_t *starts,
                  int64_t *off0s, int64_t *takes) {
    auto &c = *((Handle *)hp)->current;
    size_t m = c.meta_gid.size();
    memcpy(gids, c.meta_gid.data(), m * sizeof(int64_t));
    memcpy(lens, c.meta_len.data(), m * sizeof(int64_t));
    memcpy(starts, c.meta_start.data(), m * sizeof(int64_t));
    memcpy(off0s, c.meta_off0.data(), m * sizeof(int64_t));
    memcpy(takes, c.meta_take.data(), m * sizeof(int64_t));
}

long yx_meta_names_len(void *hp) {
    return (long)((Handle *)hp)->current->meta_names.size();
}

const char *yx_meta_names(void *hp) {
    return ((Handle *)hp)->current->meta_names.data();
}

int64_t yx_n_seq(void *hp) { return ((Handle *)hp)->stream->n_seq(); }

void yx_stats(void *hp, int64_t *out) { ((Handle *)hp)->stream->stats(out); }

void yx_close(void *hp) { delete (Handle *)hp; }

}  // extern "C"
