// In-memory slot data feed for PS-style training.
//
// Reference: paddle/fluid/framework/data_feed.h:966 InMemoryDataFeed +
// data_set.h:47 Dataset/MultiSlotDataset — C++ threads parse MultiSlot text
// files ("<n> v1 ... vn" per slot per line), hold records in memory, global
// shuffle, and emit batches to trainer threads. This is that engine for the
// TPU build: multithreaded file parsing, contiguous in-memory records,
// Fisher-Yates shuffle, and CSR-style batch emission (values + per-row
// offsets per sparse slot, dense slots as flat rows).
//
// C API (ctypes):
//   df_create(nslots, types_csv)           types: 'u' uint64 ids, 'f' float
//   df_load(h, files_csv, nthreads) -> n_records_loaded (parallel parse)
//   df_size(h) -> total records
//   df_shuffle(h, seed)
//   df_begin(h, batch_size)                 (re)start iteration
//   df_next(h) -> rows in this batch (0 = end)
//   df_slot_vals(h, slot) -> total values of this slot in current batch
//   df_slot_copy_u(h, slot, uint64* vals, int64* offs)   sparse slot
//   df_slot_copy_f(h, slot, float* vals, int64* offs)    float slot
//   df_destroy(h)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <map>
#include <mutex>
#include <random>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Record {
  // per slot: value span in the feed's arena
  std::vector<std::vector<uint64_t>> u_slots;
  std::vector<std::vector<float>> f_slots;
};

struct Feed {
  int nslots = 0;
  std::vector<char> types;  // 'u' or 'f' per slot
  std::vector<Record> records;
  std::mutex mu;
  // iteration state
  size_t cursor = 0;
  int batch_size = 1;
  size_t batch_begin = 0, batch_rows = 0;

  bool parse_line(const std::string& line, Record* rec) {
    std::istringstream is(line);
    rec->u_slots.assign(static_cast<size_t>(nslots), {});
    rec->f_slots.assign(static_cast<size_t>(nslots), {});
    for (int s = 0; s < nslots; ++s) {
      long long n;
      if (!(is >> n) || n < 0) return false;
      if (types[static_cast<size_t>(s)] == 'u') {
        auto& v = rec->u_slots[static_cast<size_t>(s)];
        v.resize(static_cast<size_t>(n));
        for (long long i = 0; i < n; ++i)
          if (!(is >> v[static_cast<size_t>(i)])) return false;
      } else {
        auto& v = rec->f_slots[static_cast<size_t>(s)];
        v.resize(static_cast<size_t>(n));
        for (long long i = 0; i < n; ++i)
          if (!(is >> v[static_cast<size_t>(i)])) return false;
      }
    }
    return true;
  }

  long long load(const std::vector<std::string>& files, int nthreads) {
    std::atomic<size_t> next{0};
    std::vector<std::vector<Record>> partials(
        static_cast<size_t>(std::max(1, nthreads)));
    auto work = [&](int tid) {
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= files.size()) break;
        std::ifstream in(files[i]);
        std::string line;
        while (std::getline(in, line)) {
          if (line.empty()) continue;
          Record r;
          if (parse_line(line, &r))
            partials[static_cast<size_t>(tid)].push_back(std::move(r));
        }
      }
    };
    std::vector<std::thread> ts;
    for (int t = 0; t < std::max(1, nthreads); ++t) ts.emplace_back(work, t);
    for (auto& t : ts) t.join();
    std::lock_guard<std::mutex> g(mu);
    long long n = 0;
    for (auto& p : partials) {
      n += static_cast<long long>(p.size());
      for (auto& r : p) records.push_back(std::move(r));
    }
    return n;
  }
};

std::mutex g_mu;
std::map<int, Feed*> g_feeds;
int g_next = 1;

Feed* get(int h) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_feeds.find(h);
  return it == g_feeds.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

int df_create(int nslots, const char* types_csv) {
  Feed* f = new Feed();
  f->nslots = nslots;
  std::string s(types_csv ? types_csv : "");
  for (char c : s)
    if (c == 'u' || c == 'f') f->types.push_back(c);
  if (static_cast<int>(f->types.size()) != nslots) {
    delete f;
    return -1;
  }
  std::lock_guard<std::mutex> g(g_mu);
  int h = g_next++;
  g_feeds[h] = f;
  return h;
}

long long df_load(int h, const char* files_csv, int nthreads) {
  Feed* f = get(h);
  if (!f) return -1;
  std::vector<std::string> files;
  std::string s(files_csv ? files_csv : "");
  size_t pos = 0;
  while (pos != std::string::npos && pos < s.size()) {
    size_t comma = s.find(',', pos);
    files.push_back(s.substr(
        pos, comma == std::string::npos ? std::string::npos : comma - pos));
    pos = comma == std::string::npos ? comma : comma + 1;
  }
  return f->load(files, nthreads);
}

long long df_size(int h) {
  Feed* f = get(h);
  if (!f) return -1;
  std::lock_guard<std::mutex> g(f->mu);
  return static_cast<long long>(f->records.size());
}

void df_shuffle(int h, long long seed) {
  Feed* f = get(h);
  if (!f) return;
  std::lock_guard<std::mutex> g(f->mu);
  std::mt19937_64 rng(static_cast<uint64_t>(seed));
  std::shuffle(f->records.begin(), f->records.end(), rng);
}

void df_begin(int h, int batch_size) {
  Feed* f = get(h);
  if (!f) return;
  std::lock_guard<std::mutex> g(f->mu);
  f->cursor = 0;
  f->batch_size = batch_size > 0 ? batch_size : 1;
  f->batch_rows = 0;
}

long long df_next(int h) {
  Feed* f = get(h);
  if (!f) return -1;
  std::lock_guard<std::mutex> g(f->mu);
  if (f->cursor >= f->records.size()) return 0;
  f->batch_begin = f->cursor;
  f->batch_rows = std::min(static_cast<size_t>(f->batch_size),
                           f->records.size() - f->cursor);
  f->cursor += f->batch_rows;
  return static_cast<long long>(f->batch_rows);
}

long long df_slot_vals(int h, int slot) {
  Feed* f = get(h);
  if (!f) return -1;
  std::lock_guard<std::mutex> g(f->mu);
  long long n = 0;
  for (size_t r = f->batch_begin; r < f->batch_begin + f->batch_rows; ++r) {
    const Record& rec = f->records[r];
    n += static_cast<long long>(
        f->types[static_cast<size_t>(slot)] == 'u'
            ? rec.u_slots[static_cast<size_t>(slot)].size()
            : rec.f_slots[static_cast<size_t>(slot)].size());
  }
  return n;
}

int df_slot_copy_u(int h, int slot, uint64_t* vals, long long* offs) {
  Feed* f = get(h);
  if (!f) return -1;
  std::lock_guard<std::mutex> g(f->mu);
  long long off = 0;
  long long row = 0;
  for (size_t r = f->batch_begin; r < f->batch_begin + f->batch_rows; ++r) {
    offs[row++] = off;
    const auto& v = f->records[r].u_slots[static_cast<size_t>(slot)];
    std::memcpy(vals + off, v.data(), v.size() * sizeof(uint64_t));
    off += static_cast<long long>(v.size());
  }
  offs[row] = off;
  return 0;
}

int df_slot_copy_f(int h, int slot, float* vals, long long* offs) {
  Feed* f = get(h);
  if (!f) return -1;
  std::lock_guard<std::mutex> g(f->mu);
  long long off = 0;
  long long row = 0;
  for (size_t r = f->batch_begin; r < f->batch_begin + f->batch_rows; ++r) {
    offs[row++] = off;
    const auto& v = f->records[r].f_slots[static_cast<size_t>(slot)];
    std::memcpy(vals + off, v.data(), v.size() * sizeof(float));
    off += static_cast<long long>(v.size());
  }
  offs[row] = off;
  return 0;
}

void df_destroy(int h) {
  Feed* f = nullptr;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_feeds.find(h);
    if (it == g_feeds.end()) return;
    f = it->second;
    g_feeds.erase(it);
  }
  delete f;
}

}  // extern "C"
