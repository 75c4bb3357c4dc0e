// cwsl_native: native runtime components for CWSL_DIGI_TPU.
//
// Native equivalents of the reference's C++ runtime pieces:
//  - lock-free SPSC/SPMC block ring buffers
//    (reference: source/ring_buffer.h:30-157, source/ring_buffer_spmc.h:30-190)
//  - POSIX shared-memory IQ source with the SM_HDR-equivalent header
//    (reference: source/SharedMemory.{h,cpp} — Win32 file mapping + event;
//     here shm_open+mmap with a polled write counter, layout shared with
//     cwsl_digi_tpu/sdr/shm.py)
//  - a native intake pump thread copying shm blocks into a ring with
//    backpressure (reference: Receiver::readIQ, source/Receiver.hpp:209-276)
//
// Exposed as a plain C ABI consumed via ctypes (cwsl_digi_tpu/native.py).
// Build: g++ -O2 -shared -fPIC -pthread -o libcwsl_native.so cwsl_native.cpp -lrt

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

using Clock = std::chrono::steady_clock;

double now_s() {
    return std::chrono::duration<double>(Clock::now().time_since_epoch()).count();
}

// ---------------------------------------------------------------------------
// Block ring buffer (single producer, N consumers with independent cursors).
// Semantics mirror the reference rings: the producer blocks (spins/sleeps)
// while any registered reader is a full lap behind (backpressure stalls
// ingest, reference ring_buffer_spmc.h:65-68); each reader pops
// independently.
// ---------------------------------------------------------------------------
struct Ring {
    size_t block_bytes;
    size_t n_blocks;
    std::vector<uint8_t> data;
    std::atomic<uint64_t> write_count{0};
    static constexpr int MAX_READERS = 16;
    std::atomic<uint64_t> read_count[MAX_READERS];
    std::atomic<int> n_readers{0};

    Ring(size_t bb, size_t nb) : block_bytes(bb), n_blocks(nb), data(bb * nb) {
        for (auto &rc : read_count) rc.store(0);
    }

    bool full() const {
        uint64_t w = write_count.load(std::memory_order_acquire);
        int nr = n_readers.load(std::memory_order_acquire);
        for (int i = 0; i < nr; ++i) {
            if (w - read_count[i].load(std::memory_order_acquire) >= n_blocks)
                return true;
        }
        return false;
    }
};

// ---------------------------------------------------------------------------
// Shared-memory IQ source (header layout from cwsl_digi_tpu/sdr/shm.py):
//   0: u32 magic 0x43575344   4: u32 sample_rate   8: u32 block_in_samples
//  12: i64 l0                20: u32 num_blocks   24: u64 write_counter
//  64: ring payload (num_blocks * block_in_samples complex64)
// ---------------------------------------------------------------------------
constexpr uint32_t kMagic = 0x43575344;
constexpr size_t kHeader = 64;

struct ShmSource {
    int fd = -1;
    uint8_t *map = nullptr;
    size_t map_len = 0;
    uint32_t sample_rate = 0;
    uint32_t block_in_samples = 0;
    int64_t l0 = 0;
    uint32_t num_blocks = 0;
    uint64_t read_cursor = 0;

    uint64_t write_counter() const {
        uint64_t v;
        __atomic_load(reinterpret_cast<const uint64_t *>(map + 24), &v,
                      __ATOMIC_ACQUIRE);
        return v;
    }
};

}  // namespace

extern "C" {

// -- ring -------------------------------------------------------------------

void *ring_create(size_t block_bytes, size_t n_blocks) {
    return new Ring(block_bytes, n_blocks);
}

void ring_destroy(void *r) { delete static_cast<Ring *>(r); }

int ring_add_reader(void *rp) {
    auto *r = static_cast<Ring *>(rp);
    int id = r->n_readers.load();
    if (id >= Ring::MAX_READERS) return -1;
    // new readers start at the current head
    r->read_count[id].store(r->write_count.load());
    r->n_readers.store(id + 1, std::memory_order_release);
    return id;
}

// 0 on success, -1 on timeout (ring stayed full: backpressure)
int ring_push(void *rp, const void *block, double timeout_s) {
    auto *r = static_cast<Ring *>(rp);
    double deadline = now_s() + timeout_s;
    while (r->full()) {
        if (now_s() >= deadline) return -1;
        std::this_thread::yield();
    }
    uint64_t w = r->write_count.load(std::memory_order_relaxed);
    std::memcpy(r->data.data() + (w % r->n_blocks) * r->block_bytes, block,
                r->block_bytes);
    r->write_count.store(w + 1, std::memory_order_release);
    return 0;
}

// 0 on success, -1 on timeout (no data)
int ring_pop(void *rp, int reader, void *out, double timeout_s) {
    auto *r = static_cast<Ring *>(rp);
    if (reader < 0 || reader >= r->n_readers.load()) return -2;
    auto &rc = r->read_count[reader];
    double deadline = now_s() + timeout_s;
    while (rc.load(std::memory_order_acquire) >=
           r->write_count.load(std::memory_order_acquire)) {
        if (now_s() >= deadline) return -1;
        std::this_thread::sleep_for(std::chrono::microseconds(200));
    }
    uint64_t c = rc.load(std::memory_order_relaxed);
    std::memcpy(out, r->data.data() + (c % r->n_blocks) * r->block_bytes,
                r->block_bytes);
    rc.store(c + 1, std::memory_order_release);
    return 0;
}

uint64_t ring_write_count(void *rp) {
    return static_cast<Ring *>(rp)->write_count.load();
}

size_t ring_pending(void *rp, int reader) {
    auto *r = static_cast<Ring *>(rp);
    if (reader < 0 || reader >= r->n_readers.load()) return 0;
    return static_cast<size_t>(r->write_count.load() -
                               r->read_count[reader].load());
}

// -- shm source -------------------------------------------------------------

void *cwsl_shm_open(const char *name) {
    std::string n = name[0] == '/' ? name : std::string("/") + name;
    int fd = shm_open(n.c_str(), O_RDONLY, 0);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
    auto *map = static_cast<uint8_t *>(
        mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0));
    if (map == MAP_FAILED) { close(fd); return nullptr; }
    uint32_t magic;
    std::memcpy(&magic, map, 4);
    if (magic != kMagic) { munmap(map, st.st_size); close(fd); return nullptr; }
    auto *s = new ShmSource();
    s->fd = fd;
    s->map = map;
    s->map_len = st.st_size;
    std::memcpy(&s->sample_rate, map + 4, 4);
    std::memcpy(&s->block_in_samples, map + 8, 4);
    std::memcpy(&s->l0, map + 12, 8);
    std::memcpy(&s->num_blocks, map + 20, 4);
    s->read_cursor = s->write_counter();   // join at the live head
    return s;
}

void cwsl_shm_close(void *sp) {
    auto *s = static_cast<ShmSource *>(sp);
    if (s->map) munmap(s->map, s->map_len);
    if (s->fd >= 0) close(s->fd);
    delete s;
}

int cwsl_shm_info(void *sp, uint32_t *sr, uint32_t *bis, int64_t *l0,
                  uint32_t *nb) {
    auto *s = static_cast<ShmSource *>(sp);
    *sr = s->sample_rate;
    *bis = s->block_in_samples;
    *l0 = s->l0;
    *nb = s->num_blocks;
    return 0;
}

// 0 ok, -1 timeout; skips forward on overrun (reference analogue:
// Receiver keeps only the freshest data when it falls behind)
int cwsl_shm_read(void *sp, void *out, double timeout_s) {
    auto *s = static_cast<ShmSource *>(sp);
    double deadline = now_s() + timeout_s;
    while (s->write_counter() <= s->read_cursor) {
        if (now_s() >= deadline) return -1;
        std::this_thread::sleep_for(std::chrono::microseconds(500));
    }
    uint64_t wc = s->write_counter();
    if (wc - s->read_cursor >= s->num_blocks)
        s->read_cursor = wc - s->num_blocks + 1;
    size_t bytes = static_cast<size_t>(s->block_in_samples) * 8;
    std::memcpy(out,
                s->map + kHeader + (s->read_cursor % s->num_blocks) * bytes,
                bytes);
    s->read_cursor += 1;
    return 0;
}

// -- intake pump ------------------------------------------------------------

struct Pump {
    ShmSource *src;
    Ring *ring;
    std::atomic<bool> stop{false};
    std::atomic<uint64_t> blocks{0};
    std::atomic<uint64_t> dropped{0};
    std::thread thread;
};

void *pump_start(void *shm, void *ring) {
    auto *p = new Pump();
    p->src = static_cast<ShmSource *>(shm);
    p->ring = static_cast<Ring *>(ring);
    p->thread = std::thread([p] {
        size_t bytes = static_cast<size_t>(p->src->block_in_samples) * 8;
        std::vector<uint8_t> buf(bytes);
        while (!p->stop.load(std::memory_order_acquire)) {
            if (cwsl_shm_read(p->src, buf.data(), 0.25) != 0) continue;
            if (ring_push(p->ring, buf.data(), 1.0) == 0)
                p->blocks.fetch_add(1);
            else
                p->dropped.fetch_add(1);
        }
    });
    return p;
}

void pump_stop(void *pp) {
    auto *p = static_cast<Pump *>(pp);
    p->stop.store(true, std::memory_order_release);
    if (p->thread.joinable()) p->thread.join();
    delete p;
}

uint64_t pump_blocks(void *pp) { return static_cast<Pump *>(pp)->blocks.load(); }
uint64_t pump_dropped(void *pp) { return static_cast<Pump *>(pp)->dropped.load(); }

}  // extern "C"
