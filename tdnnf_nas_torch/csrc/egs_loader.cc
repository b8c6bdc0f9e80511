// Native streaming egs loader: binary egs shards -> prefetched batches.
//
// The port's own copy of the reference's native/egs_loader.cc, built by
// tdnnf_nas_torch/data/native.py.  It differs in how the producer thread
// stops: `stop` is set only while holding `mu`, and every exit path
// (egs_loader_destroy, a failed read_chunk, the producer's own return)
// wakes both condition variables, so neither a producer waiting on a full
// queue nor a consumer waiting on an empty one can miss the wake-up.
//
// The C++ runtime counterpart of the reference's egs I/O
// (nnet3-chain-copy-egs / randomization pipeline feeding nnet3-chain-train,
// SURVEY.md §3.1): a background producer thread reads chunk records from a
// TEGS shard (written by data/egs_file.py), shuffles per epoch, assembles
// fixed-shape batches and hands them over through a bounded queue so the
// host never stalls the device step.
//
// Format (little-endian), version 1:
//   magic "TEGS" | i32 version | i32 num_chunks | i32 t_in | i32 feat_dim
//   | i32 t_out | i32 max_states
//   then per chunk:
//     feats   f32 [t_in, feat_dim]
//     next_w  f32 [max_states/2]
//     pdf     i32 [max_states]
//     init    f32 [max_states]
//     final   f32 [max_states]
//     mask    u8  [t_out, max_states]
//

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Header {
    char magic[4];
    int32_t version;
    int32_t num_chunks;
    int32_t t_in;
    int32_t feat_dim;
    int32_t t_out;
    int32_t max_states;
};

struct Batch {
    std::vector<float> feats;
    std::vector<float> next_w;
    std::vector<int32_t> pdf;
    std::vector<float> init;
    std::vector<float> final_w;
    std::vector<uint8_t> mask;
};

struct Loader {
    FILE* f = nullptr;
    Header hdr{};
    int32_t batch_size = 0;
    size_t chunk_bytes = 0;
    size_t data_start = 0;
    std::vector<int32_t> order;
    size_t pos = 0;
    std::mt19937_64 rng;

    std::deque<Batch> queue;
    size_t queue_depth = 4;
    std::mutex mu;
    std::condition_variable cv_produce, cv_consume;
    std::thread worker;
    std::atomic<bool> stop{false};

    size_t n_pairs() const { return (size_t)hdr.max_states / 2; }
    size_t feats_n() const { return (size_t)hdr.t_in * hdr.feat_dim; }
    size_t mask_n() const { return (size_t)hdr.t_out * hdr.max_states; }

    bool read_chunk(int32_t idx, Batch* b, int32_t slot) {
        const size_t off = data_start + (size_t)idx * chunk_bytes;
        if (fseek(f, (long)off, SEEK_SET) != 0) return false;
        const int32_t s = hdr.max_states;
        float* fp = b->feats.data() + (size_t)slot * feats_n();
        if (fread(fp, 4, feats_n(), f) != feats_n()) return false;
        if (fread(b->next_w.data() + (size_t)slot * n_pairs(), 4, n_pairs(), f)
            != n_pairs()) return false;
        if (fread(b->pdf.data() + (size_t)slot * s, 4, s, f) != (size_t)s)
            return false;
        if (fread(b->init.data() + (size_t)slot * s, 4, s, f) != (size_t)s)
            return false;
        if (fread(b->final_w.data() + (size_t)slot * s, 4, s, f) != (size_t)s)
            return false;
        uint8_t* mp = b->mask.data() + (size_t)slot * mask_n();
        if (fread(mp, 1, mask_n(), f) != mask_n()) return false;
        return true;
    }

    // Sets `stop` under `mu` and wakes every waiter: a waiter checks its
    // predicate under `mu`, so it either sees `stop` or is already
    // waiting when the notification comes.
    void request_stop() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop.store(true);
        }
        cv_produce.notify_all();
        cv_consume.notify_all();
    }

    void produce_loop() {
        produce_batches();
        request_stop();
    }

    void produce_batches() {
        while (!stop.load()) {
            Batch b;
            b.feats.resize((size_t)batch_size * feats_n());
            b.next_w.resize((size_t)batch_size * n_pairs());
            b.pdf.resize((size_t)batch_size * hdr.max_states);
            b.init.resize((size_t)batch_size * hdr.max_states);
            b.final_w.resize((size_t)batch_size * hdr.max_states);
            b.mask.resize((size_t)batch_size * mask_n());
            for (int32_t i = 0; i < batch_size; ++i) {
                if (pos >= order.size()) {
                    std::shuffle(order.begin(), order.end(), rng);
                    pos = 0;
                }
                if (!read_chunk(order[pos++], &b, i)) return;
            }
            std::unique_lock<std::mutex> lk(mu);
            cv_produce.wait(lk, [&] {
                return queue.size() < queue_depth || stop.load();
            });
            if (stop.load()) return;
            queue.push_back(std::move(b));
            cv_consume.notify_one();
        }
    }
};

}  // namespace

extern "C" {

void* egs_loader_create(const char* path, int32_t batch_size,
                        int32_t queue_depth, uint64_t seed) {
    auto* l = new Loader();
    l->f = fopen(path, "rb");
    if (!l->f) { delete l; return nullptr; }
    if (fread(&l->hdr, sizeof(Header), 1, l->f) != 1 ||
        memcmp(l->hdr.magic, "TEGS", 4) != 0 || l->hdr.version != 1) {
        fclose(l->f); delete l; return nullptr;
    }
    l->batch_size = batch_size;
    l->queue_depth = (size_t)queue_depth;
    l->data_start = sizeof(Header);
    const int32_t s = l->hdr.max_states;
    l->chunk_bytes = 4 * l->feats_n() + 4 * l->n_pairs() + 4 * (size_t)s * 3
                     + l->mask_n();
    l->order.resize(l->hdr.num_chunks);
    for (int32_t i = 0; i < l->hdr.num_chunks; ++i) l->order[i] = i;
    l->rng.seed(seed);
    std::shuffle(l->order.begin(), l->order.end(), l->rng);
    l->worker = std::thread([l] { l->produce_loop(); });
    return l;
}

// Copies the next batch into caller buffers; returns 1 on success.
// mask is returned as the raw 0/1 uint8 stored in the shard (the
// supervision kernels consume it via `mask > 0`; shipping u8 quarters the
// host->device bytes of the biggest supervision tensor).
int32_t egs_loader_next(void* handle, float* feats, float* next_w,
                        int32_t* pdf, float* init, float* final_w,
                        uint8_t* mask) {
    auto* l = (Loader*)handle;
    Batch b;
    {
        std::unique_lock<std::mutex> lk(l->mu);
        l->cv_consume.wait(lk, [&] { return !l->queue.empty() || l->stop.load(); });
        if (l->queue.empty()) return 0;
        b = std::move(l->queue.front());
        l->queue.pop_front();
        l->cv_produce.notify_one();
    }
    memcpy(feats, b.feats.data(), b.feats.size() * 4);
    memcpy(next_w, b.next_w.data(), b.next_w.size() * 4);
    memcpy(pdf, b.pdf.data(), b.pdf.size() * 4);
    memcpy(init, b.init.data(), b.init.size() * 4);
    memcpy(final_w, b.final_w.data(), b.final_w.size() * 4);
    memcpy(mask, b.mask.data(), b.mask.size());
    return 1;
}

void egs_loader_destroy(void* handle) {
    auto* l = (Loader*)handle;
    l->request_stop();
    if (l->worker.joinable()) l->worker.join();
    if (l->f) fclose(l->f);
    delete l;
}

}  // extern "C"
