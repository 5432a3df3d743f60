// Parameter-server tables + service: C++ sharded sparse/dense tables behind a
// TCP service, mirroring the reference PS stack (paddle/fluid/distributed/ps/):
//   - MemorySparseTable  (ps/table/memory_sparse_table.cc): hash shards of
//     id -> [embedding row | optimizer slots], created on first pull.
//   - MemoryDenseTable   (ps/table/memory_dense_table.cc): flat parameter vector.
//   - PsService          (ps/service/brpc_ps_server.cc): pull/push RPCs — brpc
//     there, the same length-prefixed TCP protocol as tcp_store.cc here.
// Server-side optimizers (sparse SGD/Adagrad/Adam; reference ctr_sparse_sgd
// rules in ps/table/sparse_sgd_rule.cc) apply pushed gradients in place.
//
// Wire protocol: u8 cmd | u32 table_id | u32 n | payload...   replies: i64 status | payload
//   cmd: 0=PULL_SPARSE (n u64 ids)                -> n*dim f32
//        1=PUSH_SPARSE (n u64 ids | u32 nfloats | nfloats f32 grads)
//        2=PULL_DENSE                              -> dim f32
//        3=PUSH_DENSE  (u32 nfloats | nfloats f32 grads)
//        4=SAVE (path)  5=LOAD (path)  6=BARRIER(key, world; reusable rounds)
//        7=STOP  8=PUSH_DENSE_PARAM (u32 nfloats | nfloats f32; no optimizer)
// Pushes carry an explicit float count so a bad table_id/dim never desyncs the
// connection (the server always drains the payload before replying an error).
#include <algorithm>
#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

// ---------------- shared socket helpers (same as tcp_store.cc) ----------------
bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool send_u32(int fd, uint32_t v) { uint32_t n = htonl(v); return send_all(fd, &n, 4); }
bool recv_u32(int fd, uint32_t* v) {
  uint32_t n;
  if (!recv_all(fd, &n, 4)) return false;
  *v = ntohl(n);
  return true;
}
bool send_i64(int fd, int64_t v) {
  uint64_t n = htobe64(static_cast<uint64_t>(v));
  return send_all(fd, &n, 8);
}
bool recv_i64(int fd, int64_t* v) {
  uint64_t n;
  if (!recv_all(fd, &n, 8)) return false;
  *v = static_cast<int64_t>(be64toh(n));
  return true;
}

enum Cmd : uint8_t {
  kPullSparse = 0, kPushSparse = 1, kPullDense = 2, kPushDense = 3,
  kSave = 4, kLoad = 5, kBarrier = 6, kStop = 7, kPushDenseParam = 8,
  // geo-SGD delta aggregation (reference memory_sparse_geo_table.cc): the
  // server ADDS trainer deltas to the parameter — no server-side optimizer
  kPushDenseDelta = 9, kPushSparseDelta = 10,
  // GNN graph store (reference common_graph_table.cc)
  kGraphAddEdges = 11, kGraphSample = 12, kGraphSetFeat = 13,
  kGraphGetFeat = 14, kGraphDegree = 15,
};

enum OptType : int { kSGD = 0, kAdagrad = 1, kAdam = 2 };

struct TableConfig {
  int dim = 8;          // embedding/parameter dimension
  int opt = kSGD;       // server-side optimizer
  float lr = 0.01f;
  float initial_range = 0.1f;  // uniform init for new sparse rows
  int shard_num = 8;
};

// slots per id beyond the embedding row
int slots_for(int opt, int dim) {
  switch (opt) {
    case kAdagrad: return dim;      // g2sum
    case kAdam: return 2 * dim + 1; // m, v, beta_pow step counter
    default: return 0;
  }
}

void apply_opt(int opt, float lr, int dim, float* w, float* s, const float* g) {
  switch (opt) {
    case kSGD:
      for (int i = 0; i < dim; ++i) w[i] -= lr * g[i];
      break;
    case kAdagrad:
      for (int i = 0; i < dim; ++i) {
        s[i] += g[i] * g[i];
        w[i] -= lr * g[i] / (std::sqrt(s[i]) + 1e-6f);
      }
      break;
    case kAdam: {
      const float b1 = 0.9f, b2 = 0.999f, eps = 1e-8f;
      float* m = s;
      float* v = s + dim;
      float& t = s[2 * dim];
      t += 1.0f;
      for (int i = 0; i < dim; ++i) {
        m[i] = b1 * m[i] + (1 - b1) * g[i];
        v[i] = b2 * v[i] + (1 - b2) * g[i] * g[i];
        float mhat = m[i] / (1 - std::pow(b1, t));
        float vhat = v[i] / (1 - std::pow(b2, t));
        w[i] -= lr * mhat / (std::sqrt(vhat) + eps);
      }
      break;
    }
  }
}

// ---------------- tables ----------------
class SparseTable {
 public:
  explicit SparseTable(const TableConfig& cfg)
      : cfg_(cfg), row_len_(cfg.dim + slots_for(cfg.opt, cfg.dim)),
        shards_(cfg.shard_num), locks_(cfg.shard_num) {}

  void Pull(const uint64_t* ids, int n, float* out) {
    for (int i = 0; i < n; ++i) {
      size_t s = ids[i] % shards_.size();
      std::lock_guard<std::mutex> lk(locks_[s]);
      auto& row = GetOrInit(s, ids[i]);
      std::memcpy(out + i * cfg_.dim, row.data(), cfg_.dim * sizeof(float));
    }
  }

  void Push(const uint64_t* ids, int n, const float* grads) {
    for (int i = 0; i < n; ++i) {
      size_t s = ids[i] % shards_.size();
      std::lock_guard<std::mutex> lk(locks_[s]);
      auto& row = GetOrInit(s, ids[i]);
      apply_opt(cfg_.opt, cfg_.lr, cfg_.dim, row.data(), row.data() + cfg_.dim,
                grads + i * cfg_.dim);
    }
  }

  // geo-SGD: w += delta, no optimizer state touched
  // (memory_sparse_geo_table.cc _PushSparse semantics)
  void AddDelta(const uint64_t* ids, int n, const float* deltas) {
    for (int i = 0; i < n; ++i) {
      size_t s = ids[i] % shards_.size();
      std::lock_guard<std::mutex> lk(locks_[s]);
      auto& row = GetOrInit(s, ids[i]);
      for (int j = 0; j < cfg_.dim; ++j) row[j] += deltas[i * cfg_.dim + j];
    }
  }

  bool Save(FILE* f) {
    for (size_t s = 0; s < shards_.size(); ++s) {
      std::lock_guard<std::mutex> lk(locks_[s]);
      for (auto& kv : shards_[s]) {
        if (fwrite(&kv.first, sizeof(uint64_t), 1, f) != 1) return false;
        if (fwrite(kv.second.data(), sizeof(float), row_len_, f) !=
            static_cast<size_t>(row_len_))
          return false;
      }
    }
    return true;
  }

  bool Load(FILE* f) {
    uint64_t id;
    std::vector<float> row(row_len_);
    while (fread(&id, sizeof(uint64_t), 1, f) == 1) {
      if (fread(row.data(), sizeof(float), row_len_, f) !=
          static_cast<size_t>(row_len_))
        return false;
      size_t s = id % shards_.size();
      std::lock_guard<std::mutex> lk(locks_[s]);
      shards_[s][id] = row;
    }
    return true;
  }

  int64_t Size() {
    int64_t n = 0;
    for (size_t s = 0; s < shards_.size(); ++s) {
      std::lock_guard<std::mutex> lk(locks_[s]);
      n += static_cast<int64_t>(shards_[s].size());
    }
    return n;
  }

  const TableConfig& config() const { return cfg_; }

 private:
  std::vector<float>& GetOrInit(size_t shard, uint64_t id) {
    auto it = shards_[shard].find(id);
    if (it != shards_[shard].end()) return it->second;
    std::vector<float> row(row_len_, 0.0f);
    // deterministic per-id uniform init in [-range, range] (splitmix64 hash),
    // so every server/restart agrees without coordination
    uint64_t x = id + 0x9E3779B97F4A7C15ull;
    for (int i = 0; i < cfg_.dim; ++i) {
      x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ull;
      x ^= x >> 27; x *= 0x94D049BB133111EBull;
      x ^= x >> 31;
      float u = static_cast<float>(x >> 11) / static_cast<float>(1ull << 53);
      row[i] = (2.0f * u - 1.0f) * cfg_.initial_range;
    }
    return shards_[shard].emplace(id, std::move(row)).first->second;
  }

  TableConfig cfg_;
  int row_len_;
  std::vector<std::unordered_map<uint64_t, std::vector<float>>> shards_;
  std::vector<std::mutex> locks_;
};

class DenseTable {
 public:
  explicit DenseTable(const TableConfig& cfg)
      : cfg_(cfg), w_(cfg.dim, 0.0f), slots_(slots_for(cfg.opt, cfg.dim), 0.0f) {}

  void Pull(float* out) {
    std::lock_guard<std::mutex> lk(mu_);
    std::memcpy(out, w_.data(), w_.size() * sizeof(float));
  }

  void Push(const float* grads) {
    std::lock_guard<std::mutex> lk(mu_);
    apply_opt(cfg_.opt, cfg_.lr, cfg_.dim, w_.data(),
              slots_.empty() ? nullptr : slots_.data(), grads);
  }

  void SetParam(const float* values) {
    std::lock_guard<std::mutex> lk(mu_);
    std::memcpy(w_.data(), values, w_.size() * sizeof(float));
  }

  // geo-SGD: w += delta (deltas from several trainers aggregate by addition)
  void AddDelta(const float* delta) {
    std::lock_guard<std::mutex> lk(mu_);
    for (size_t i = 0; i < w_.size(); ++i) w_[i] += delta[i];
  }

  bool Save(FILE* f) {
    std::lock_guard<std::mutex> lk(mu_);
    return fwrite(w_.data(), sizeof(float), w_.size(), f) == w_.size();
  }

  bool Load(FILE* f) {
    std::lock_guard<std::mutex> lk(mu_);
    return fread(w_.data(), sizeof(float), w_.size(), f) == w_.size();
  }

  const TableConfig& config() const { return cfg_; }

 private:
  TableConfig cfg_;
  std::vector<float> w_;
  std::vector<float> slots_;
  std::mutex mu_;
};

// ---------------- graph table (reference common_graph_table.cc) ----------------
class GraphTable {
  // TPU-native design delta: the reference's 1.3k-LoC graph table carries
  // GPU-cache plumbing and protobuf sampling configs; the contract GNN
  // training actually needs is (add edges, per-node features, uniform
  // neighbor sampling, degree) over an id-sharded store — which is what
  // this provides, behind the same PS wire protocol as the other tables.
 public:
  GraphTable(int feat_dim, int shard_num)
      : feat_dim_(feat_dim), shards_(shard_num), locks_(shard_num) {}

  void AddEdges(const uint64_t* src, const uint64_t* dst, int n) {
    for (int i = 0; i < n; ++i) {
      size_t s = src[i] % shards_.size();
      std::lock_guard<std::mutex> lk(locks_[s]);
      shards_[s][src[i]].nbrs.push_back(dst[i]);
    }
  }

  void Degree(const uint64_t* ids, int n, int64_t* out) {
    for (int i = 0; i < n; ++i) {
      size_t s = ids[i] % shards_.size();
      std::lock_guard<std::mutex> lk(locks_[s]);
      auto it = shards_[s].find(ids[i]);
      out[i] = it == shards_[s].end()
                   ? 0 : static_cast<int64_t>(it->second.nbrs.size());
    }
  }

  // k uniform samples WITH replacement per id (deterministic in seed);
  // nodes without neighbors fill UINT64_MAX so callers can mask
  void Sample(const uint64_t* ids, int n, int k, uint64_t seed,
              uint64_t* out) {
    for (int i = 0; i < n; ++i) {
      size_t s = ids[i] % shards_.size();
      std::lock_guard<std::mutex> lk(locks_[s]);
      auto it = shards_[s].find(ids[i]);
      if (it == shards_[s].end() || it->second.nbrs.empty()) {
        for (int j = 0; j < k; ++j) out[i * k + j] = UINT64_MAX;
        continue;
      }
      const auto& nb = it->second.nbrs;
      uint64_t x = seed ^ (ids[i] + 0x9E3779B97F4A7C15ull);
      for (int j = 0; j < k; ++j) {
        x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ull;
        x ^= x >> 27; x *= 0x94D049BB133111EBull;
        x ^= x >> 31;
        out[i * k + j] = nb[x % nb.size()];
      }
    }
  }

  void SetFeat(const uint64_t* ids, int n, const float* feats) {
    for (int i = 0; i < n; ++i) {
      size_t s = ids[i] % shards_.size();
      std::lock_guard<std::mutex> lk(locks_[s]);
      auto& node = shards_[s][ids[i]];
      node.feat.assign(feats + i * feat_dim_, feats + (i + 1) * feat_dim_);
    }
  }

  void GetFeat(const uint64_t* ids, int n, float* out) {
    for (int i = 0; i < n; ++i) {
      size_t s = ids[i] % shards_.size();
      std::lock_guard<std::mutex> lk(locks_[s]);
      auto it = shards_[s].find(ids[i]);
      // copy min(stored, feat_dim) and zero-fill the rest: a checkpoint
      // written under a different feat_dim must not read out of bounds
      size_t m = it == shards_[s].end()
                     ? 0 : std::min(it->second.feat.size(),
                                    static_cast<size_t>(feat_dim_));
      if (m)
        std::memcpy(out + i * feat_dim_, it->second.feat.data(),
                    m * sizeof(float));
      if (m < static_cast<size_t>(feat_dim_))
        std::memset(out + i * feat_dim_ + m, 0,
                    (feat_dim_ - m) * sizeof(float));
    }
  }

  bool Save(FILE* f) {
    for (size_t s = 0; s < shards_.size(); ++s) {
      std::lock_guard<std::mutex> lk(locks_[s]);
      for (auto& kv : shards_[s]) {
        uint64_t nn = kv.second.nbrs.size();
        uint64_t nf = kv.second.feat.size();
        if (fwrite(&kv.first, sizeof(uint64_t), 1, f) != 1 ||
            fwrite(&nn, sizeof(uint64_t), 1, f) != 1 ||
            fwrite(&nf, sizeof(uint64_t), 1, f) != 1)
          return false;
        if (nn && fwrite(kv.second.nbrs.data(), sizeof(uint64_t), nn, f) != nn)
          return false;
        if (nf && fwrite(kv.second.feat.data(), sizeof(float), nf, f) != nf)
          return false;
      }
    }
    return true;
  }

  bool Load(FILE* f) {
    uint64_t id, nn, nf;
    while (fread(&id, sizeof(uint64_t), 1, f) == 1) {
      if (fread(&nn, sizeof(uint64_t), 1, f) != 1 ||
          fread(&nf, sizeof(uint64_t), 1, f) != 1)
        return false;
      Node node;
      node.nbrs.resize(nn);
      node.feat.resize(nf);
      if (nn && fread(node.nbrs.data(), sizeof(uint64_t), nn, f) != nn)
        return false;
      if (nf && fread(node.feat.data(), sizeof(float), nf, f) != nf)
        return false;
      size_t s = id % shards_.size();
      std::lock_guard<std::mutex> lk(locks_[s]);
      shards_[s][id] = std::move(node);
    }
    return true;
  }

  int feat_dim() const { return feat_dim_; }

 private:
  struct Node {
    std::vector<uint64_t> nbrs;
    std::vector<float> feat;
  };
  int feat_dim_;
  std::vector<std::unordered_map<uint64_t, Node>> shards_;
  std::vector<std::mutex> locks_;
};

// ---------------- server ----------------
class PsServer {
 public:
  int Start(int port) {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return -errno;
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0)
      return -errno;
    if (port == 0) {
      socklen_t len = sizeof(addr);
      ::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &len);
      port = ntohs(addr.sin_port);
    }
    if (::listen(listen_fd_, 128) < 0) return -errno;
    accept_thread_ = std::thread([this] { AcceptLoop(); });
    return port;
  }

  void AddSparseTable(uint32_t id, const TableConfig& cfg) {
    std::lock_guard<std::mutex> lk(tables_mu_);
    sparse_[id] = std::make_unique<SparseTable>(cfg);
  }

  void AddDenseTable(uint32_t id, const TableConfig& cfg) {
    std::lock_guard<std::mutex> lk(tables_mu_);
    dense_[id] = std::make_unique<DenseTable>(cfg);
  }

  SparseTable* sparse(uint32_t id) {
    std::lock_guard<std::mutex> lk(tables_mu_);
    auto it = sparse_.find(id);
    return it == sparse_.end() ? nullptr : it->second.get();
  }

  DenseTable* dense(uint32_t id) {
    std::lock_guard<std::mutex> lk(tables_mu_);
    auto it = dense_.find(id);
    return it == dense_.end() ? nullptr : it->second.get();
  }

  void AddGraphTable(uint32_t id, int feat_dim, int shard_num) {
    std::lock_guard<std::mutex> lk(tables_mu_);
    graph_[id] = std::make_unique<GraphTable>(feat_dim,
                                              shard_num > 0 ? shard_num : 8);
  }

  GraphTable* graph(uint32_t id) {
    std::lock_guard<std::mutex> lk(tables_mu_);
    auto it = graph_.find(id);
    return it == graph_.end() ? nullptr : it->second.get();
  }

  bool stop_requested() const { return stop_requested_.load(); }

  void Stop() {
    if (stopping_.exchange(true)) return;
    {
      // close the lost-wakeup window for threads entering the barrier wait
      std::lock_guard<std::mutex> lk(barrier_mu_);
    }
    barrier_cv_.notify_all();
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
    if (accept_thread_.joinable()) accept_thread_.join();
    std::vector<std::thread> workers;
    {
      std::lock_guard<std::mutex> lk(workers_mu_);
      for (int fd : conn_fds_) ::shutdown(fd, SHUT_RDWR);
      workers.swap(workers_);
    }
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }

  ~PsServer() { Stop(); }

 private:
  void AcceptLoop() {
    while (true) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        if (errno == EINTR) continue;
        return;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> lk(workers_mu_);
      if (stopping_) { ::close(fd); return; }
      conn_fds_.push_back(fd);
      workers_.emplace_back([this, fd] { Serve(fd); });
    }
  }

  bool ReadString(int fd, std::string* s) {
    uint32_t len;
    if (!recv_u32(fd, &len)) return false;
    s->resize(len);
    return len == 0 || recv_all(fd, &(*s)[0], len);
  }

  void Serve(int fd) {
    std::vector<uint64_t> ids;
    std::vector<float> buf;
    while (true) {
      uint8_t cmd;
      uint32_t table_id, n;
      if (!recv_all(fd, &cmd, 1) || !recv_u32(fd, &table_id) || !recv_u32(fd, &n))
        break;
      bool ok = true;
      switch (cmd) {
        case kPullSparse: {
          auto* t = sparse(table_id);
          ids.resize(n);
          if (!(ok = recv_all(fd, ids.data(), n * sizeof(uint64_t)))) break;
          if (!t) { ok = send_i64(fd, -2); break; }
          buf.resize(static_cast<size_t>(n) * t->config().dim);
          t->Pull(ids.data(), n, buf.data());
          ok = send_i64(fd, 0) &&
               send_all(fd, buf.data(), buf.size() * sizeof(float));
          break;
        }
        case kPushSparse: {
          auto* t = sparse(table_id);
          ids.resize(n);
          if (!(ok = recv_all(fd, ids.data(), n * sizeof(uint64_t)))) break;
          uint32_t nfloats;  // explicit payload size so errors never desync the wire
          if (!(ok = recv_u32(fd, &nfloats))) break;
          buf.resize(nfloats);
          if (!(ok = recv_all(fd, buf.data(), nfloats * sizeof(float)))) break;
          if (!t) {
            ok = send_i64(fd, -2);
          } else if (nfloats != static_cast<size_t>(n) * t->config().dim) {
            ok = send_i64(fd, -3);  // dim mismatch between client and server
          } else {
            t->Push(ids.data(), n, buf.data());
            ok = send_i64(fd, 0);
          }
          break;
        }
        case kPullDense: {
          auto* t = dense(table_id);
          if (!t) { ok = send_i64(fd, -2); break; }
          buf.resize(t->config().dim);
          t->Pull(buf.data());
          ok = send_i64(fd, 0) &&
               send_all(fd, buf.data(), buf.size() * sizeof(float));
          break;
        }
        case kPushDense: case kPushDenseParam: case kPushDenseDelta: {
          auto* t = dense(table_id);
          uint32_t nfloats;
          if (!(ok = recv_u32(fd, &nfloats))) break;
          buf.resize(nfloats);
          if (!(ok = recv_all(fd, buf.data(), nfloats * sizeof(float)))) break;
          if (!t) {
            ok = send_i64(fd, -2);
          } else if (nfloats != static_cast<size_t>(t->config().dim)) {
            ok = send_i64(fd, -3);
          } else {
            if (cmd == kPushDense)
              t->Push(buf.data());
            else if (cmd == kPushDenseParam)
              t->SetParam(buf.data());
            else
              t->AddDelta(buf.data());
            ok = send_i64(fd, 0);
          }
          break;
        }
        case kPushSparseDelta: {
          auto* t = sparse(table_id);
          ids.resize(n);
          if (!(ok = recv_all(fd, ids.data(), n * sizeof(uint64_t)))) break;
          uint32_t nfloats;
          if (!(ok = recv_u32(fd, &nfloats))) break;
          buf.resize(nfloats);
          if (!(ok = recv_all(fd, buf.data(), nfloats * sizeof(float)))) break;
          if (!t) {
            ok = send_i64(fd, -2);
          } else if (nfloats != static_cast<size_t>(n) * t->config().dim) {
            ok = send_i64(fd, -3);
          } else {
            t->AddDelta(ids.data(), n, buf.data());
            ok = send_i64(fd, 0);
          }
          break;
        }
        case kGraphAddEdges: {
          auto* t = graph(table_id);
          ids.resize(static_cast<size_t>(n) * 2);  // src then dst
          if (!(ok = recv_all(fd, ids.data(), n * 2 * sizeof(uint64_t))))
            break;
          if (!t) { ok = send_i64(fd, -2); break; }
          t->AddEdges(ids.data(), ids.data() + n, n);
          ok = send_i64(fd, 0);
          break;
        }
        case kGraphDegree: {
          auto* t = graph(table_id);
          ids.resize(n);
          if (!(ok = recv_all(fd, ids.data(), n * sizeof(uint64_t)))) break;
          if (!t) { ok = send_i64(fd, -2); break; }
          std::vector<int64_t> deg(n);
          t->Degree(ids.data(), n, deg.data());
          ok = send_i64(fd, 0) &&
               send_all(fd, deg.data(), n * sizeof(int64_t));
          break;
        }
        case kGraphSample: {
          auto* t = graph(table_id);
          ids.resize(n);
          uint32_t k, seed;
          if (!(ok = recv_all(fd, ids.data(), n * sizeof(uint64_t)) &&
                     recv_u32(fd, &k) && recv_u32(fd, &seed)))
            break;
          if (!t) { ok = send_i64(fd, -2); break; }
          std::vector<uint64_t> samples(static_cast<size_t>(n) * k);
          t->Sample(ids.data(), n, static_cast<int>(k), seed, samples.data());
          ok = send_i64(fd, 0) &&
               send_all(fd, samples.data(),
                        samples.size() * sizeof(uint64_t));
          break;
        }
        case kGraphSetFeat: {
          auto* t = graph(table_id);
          ids.resize(n);
          if (!(ok = recv_all(fd, ids.data(), n * sizeof(uint64_t)))) break;
          uint32_t nfloats;
          if (!(ok = recv_u32(fd, &nfloats))) break;
          buf.resize(nfloats);
          if (!(ok = recv_all(fd, buf.data(), nfloats * sizeof(float)))) break;
          if (!t) {
            ok = send_i64(fd, -2);
          } else if (nfloats != static_cast<size_t>(n) * t->feat_dim()) {
            ok = send_i64(fd, -3);
          } else {
            t->SetFeat(ids.data(), n, buf.data());
            ok = send_i64(fd, 0);
          }
          break;
        }
        case kGraphGetFeat: {
          auto* t = graph(table_id);
          ids.resize(n);
          if (!(ok = recv_all(fd, ids.data(), n * sizeof(uint64_t)))) break;
          if (!t) { ok = send_i64(fd, -2); break; }
          buf.resize(static_cast<size_t>(n) * t->feat_dim());
          t->GetFeat(ids.data(), n, buf.data());
          ok = send_i64(fd, 0) &&
               send_all(fd, buf.data(), buf.size() * sizeof(float));
          break;
        }
        case kSave: case kLoad: {
          std::string path;
          if (!(ok = ReadString(fd, &path))) break;
          int64_t status = 0;
          {
            std::lock_guard<std::mutex> lk(tables_mu_);
            // one policy for every table kind: save opens "wb"; load skips
            // tables with no file (partial checkpoints are legal)
            auto io_tables = [&](auto& table_map, const char* tag) {
              for (auto& kv : table_map) {
                std::string p =
                    path + "." + tag + "." + std::to_string(kv.first);
                FILE* f = fopen(p.c_str(), cmd == kSave ? "wb" : "rb");
                if (!f) { if (cmd == kLoad) continue; status = -errno; return; }
                bool io_ok =
                    cmd == kSave ? kv.second->Save(f) : kv.second->Load(f);
                fclose(f);
                if (!io_ok) { status = -5; return; }
              }
            };
            io_tables(sparse_, "sparse");
            if (status == 0) io_tables(dense_, "dense");
            if (status == 0) io_tables(graph_, "graph");
          }
          ok = send_i64(fd, status);
          break;
        }
        case kBarrier: {
          // table_id = barrier key, n = world size. Reusable generation barrier:
          // each completion bumps the round, so the same key synchronizes every
          // step (not just the first — a sense-reversing barrier).
          std::unique_lock<std::mutex> lk(barrier_mu_);
          uint32_t key = table_id;
          int64_t my_round = barrier_round_[key];
          if (++barrier_counts_[key] >= n) {
            barrier_counts_[key] = 0;
            ++barrier_round_[key];
            barrier_cv_.notify_all();
          }
          barrier_cv_.wait(lk, [&] {
            return stopping_ || barrier_round_[key] != my_round;
          });
          ok = send_i64(fd, stopping_ ? -1 : 0);
          break;
        }
        case kStop: {
          // flag only; the hosting process polls ps_server_stop_requested() and
          // performs the actual teardown from its own thread (avoids a Serve
          // thread joining itself / use-after-free with the destructor)
          send_i64(fd, 0);
          stop_requested_.store(true);
          ::close(fd);
          std::lock_guard<std::mutex> lk(workers_mu_);
          conn_fds_.erase(std::remove(conn_fds_.begin(), conn_fds_.end(), fd),
                          conn_fds_.end());
          return;
        }
        default:
          ok = false;
      }
      if (!ok) break;
    }
    ::close(fd);
    std::lock_guard<std::mutex> lk(workers_mu_);
    conn_fds_.erase(std::remove(conn_fds_.begin(), conn_fds_.end(), fd),
                    conn_fds_.end());
  }

  int listen_fd_ = -1;
  std::atomic<bool> stopping_{false};
  std::atomic<bool> stop_requested_{false};
  std::thread accept_thread_;
  std::mutex workers_mu_;
  std::vector<std::thread> workers_;
  std::vector<int> conn_fds_;
  std::mutex tables_mu_;
  std::map<uint32_t, std::unique_ptr<SparseTable>> sparse_;
  std::map<uint32_t, std::unique_ptr<DenseTable>> dense_;
  std::map<uint32_t, std::unique_ptr<GraphTable>> graph_;
  std::mutex barrier_mu_;
  std::condition_variable barrier_cv_;
  std::map<uint32_t, int64_t> barrier_counts_;
  std::map<uint32_t, int64_t> barrier_round_;
};

// ---------------- client ----------------
class PsClient {
 public:
  int Connect(const char* host, int port, int timeout_ms) {
    addrinfo hints{};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (::getaddrinfo(host, nullptr, &hints, &res) != 0 || res == nullptr)
      return -EINVAL;
    sockaddr_in addr = *reinterpret_cast<sockaddr_in*>(res->ai_addr);
    ::freeaddrinfo(res);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    while (true) {
      fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
      if (fd_ < 0) return -errno;
      if (::connect(fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
        int one = 1;
        ::setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        return 0;
      }
      ::close(fd_);
      fd_ = -1;
      if (std::chrono::steady_clock::now() >= deadline) return -ETIMEDOUT;
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
    }
  }

  ~PsClient() {
    if (fd_ >= 0) ::close(fd_);
  }

  std::mutex mu_;
  int fd_ = -1;
};

bool send_header(int fd, uint8_t cmd, uint32_t table, uint32_t n) {
  return send_all(fd, &cmd, 1) && send_u32(fd, table) && send_u32(fd, n);
}

}  // namespace

extern "C" {

void* ps_server_start(int port, int* out_port) {
  auto* s = new PsServer();
  int got = s->Start(port);
  if (got < 0) {
    delete s;
    return nullptr;
  }
  if (out_port) *out_port = got;
  return s;
}

void ps_server_add_sparse_table(void* server, uint32_t id, int dim, int opt,
                                float lr, float initial_range, int shards) {
  TableConfig cfg;
  cfg.dim = dim;
  cfg.opt = opt;
  cfg.lr = lr;
  cfg.initial_range = initial_range;
  cfg.shard_num = shards > 0 ? shards : 8;
  static_cast<PsServer*>(server)->AddSparseTable(id, cfg);
}

void ps_server_add_dense_table(void* server, uint32_t id, int dim, int opt,
                               float lr) {
  TableConfig cfg;
  cfg.dim = dim;
  cfg.opt = opt;
  cfg.lr = lr;
  static_cast<PsServer*>(server)->AddDenseTable(id, cfg);
}

void ps_server_add_graph_table(void* server, uint32_t id, int feat_dim,
                               int shards) {
  static_cast<PsServer*>(server)->AddGraphTable(id, feat_dim, shards);
}

int64_t ps_server_sparse_size(void* server, uint32_t id) {
  auto* t = static_cast<PsServer*>(server)->sparse(id);
  return t ? t->Size() : -1;
}

void ps_server_stop(void* server) {
  delete static_cast<PsServer*>(server);
}

int ps_server_stop_requested(void* server) {
  return static_cast<PsServer*>(server)->stop_requested() ? 1 : 0;
}

void* ps_client_connect(const char* host, int port, int timeout_ms) {
  auto* c = new PsClient();
  if (c->Connect(host, port, timeout_ms) != 0) {
    delete c;
    return nullptr;
  }
  return c;
}

void ps_client_free(void* client) {
  delete static_cast<PsClient*>(client);
}

int ps_pull_sparse(void* client, uint32_t table, const uint64_t* ids, int n,
                   float* out, int dim) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  if (!send_header(c->fd_, kPullSparse, table, n) ||
      !send_all(c->fd_, ids, n * sizeof(uint64_t)))
    return -EPIPE;
  int64_t status;
  if (!recv_i64(c->fd_, &status)) return -EPIPE;
  if (status != 0) return static_cast<int>(status);
  return recv_all(c->fd_, out, static_cast<size_t>(n) * dim * sizeof(float))
             ? 0 : -EPIPE;
}

int ps_push_sparse(void* client, uint32_t table, const uint64_t* ids, int n,
                   const float* grads, int dim) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  uint32_t nfloats = static_cast<uint32_t>(n) * dim;
  if (!send_header(c->fd_, kPushSparse, table, n) ||
      !send_all(c->fd_, ids, n * sizeof(uint64_t)) ||
      !send_u32(c->fd_, nfloats) ||
      !send_all(c->fd_, grads, static_cast<size_t>(nfloats) * sizeof(float)))
    return -EPIPE;
  int64_t status;
  return recv_i64(c->fd_, &status) ? static_cast<int>(status) : -EPIPE;
}

int ps_pull_dense(void* client, uint32_t table, float* out, int dim) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  if (!send_header(c->fd_, kPullDense, table, 0)) return -EPIPE;
  int64_t status;
  if (!recv_i64(c->fd_, &status)) return -EPIPE;
  if (status != 0) return static_cast<int>(status);
  return recv_all(c->fd_, out, static_cast<size_t>(dim) * sizeof(float)) ? 0
                                                                         : -EPIPE;
}

static int push_dense_impl(void* client, uint8_t cmd, uint32_t table,
                           const float* data, int dim) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  if (!send_header(c->fd_, cmd, table, 0) ||
      !send_u32(c->fd_, static_cast<uint32_t>(dim)) ||
      !send_all(c->fd_, data, static_cast<size_t>(dim) * sizeof(float)))
    return -EPIPE;
  int64_t status;
  return recv_i64(c->fd_, &status) ? static_cast<int>(status) : -EPIPE;
}

int ps_push_dense(void* client, uint32_t table, const float* grads, int dim) {
  return push_dense_impl(client, kPushDense, table, grads, dim);
}

int ps_push_dense_param(void* client, uint32_t table, const float* values,
                        int dim) {
  return push_dense_impl(client, kPushDenseParam, table, values, dim);
}

int ps_push_dense_delta(void* client, uint32_t table, const float* delta,
                        int dim) {
  return push_dense_impl(client, kPushDenseDelta, table, delta, dim);
}

int ps_push_sparse_delta(void* client, uint32_t table, const uint64_t* ids,
                         int n, const float* deltas, int dim) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  uint32_t nfloats = static_cast<uint32_t>(n) * dim;
  if (!send_header(c->fd_, kPushSparseDelta, table, n) ||
      !send_all(c->fd_, ids, n * sizeof(uint64_t)) ||
      !send_u32(c->fd_, nfloats) ||
      !send_all(c->fd_, deltas, static_cast<size_t>(nfloats) * sizeof(float)))
    return -EPIPE;
  int64_t status;
  return recv_i64(c->fd_, &status) ? static_cast<int>(status) : -EPIPE;
}

int ps_graph_add_edges(void* client, uint32_t table, const uint64_t* src,
                       const uint64_t* dst, int n) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  if (!send_header(c->fd_, kGraphAddEdges, table, n) ||
      !send_all(c->fd_, src, n * sizeof(uint64_t)) ||
      !send_all(c->fd_, dst, n * sizeof(uint64_t)))
    return -EPIPE;
  int64_t status;
  return recv_i64(c->fd_, &status) ? static_cast<int>(status) : -EPIPE;
}

int ps_graph_degree(void* client, uint32_t table, const uint64_t* ids, int n,
                    int64_t* out) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  if (!send_header(c->fd_, kGraphDegree, table, n) ||
      !send_all(c->fd_, ids, n * sizeof(uint64_t)))
    return -EPIPE;
  int64_t status;
  if (!recv_i64(c->fd_, &status)) return -EPIPE;
  if (status != 0) return static_cast<int>(status);
  return recv_all(c->fd_, out, static_cast<size_t>(n) * sizeof(int64_t))
             ? 0 : -EPIPE;
}

int ps_graph_sample(void* client, uint32_t table, const uint64_t* ids, int n,
                    int k, uint32_t seed, uint64_t* out) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  if (!send_header(c->fd_, kGraphSample, table, n) ||
      !send_all(c->fd_, ids, n * sizeof(uint64_t)) ||
      !send_u32(c->fd_, static_cast<uint32_t>(k)) ||
      !send_u32(c->fd_, seed))
    return -EPIPE;
  int64_t status;
  if (!recv_i64(c->fd_, &status)) return -EPIPE;
  if (status != 0) return static_cast<int>(status);
  return recv_all(c->fd_, out,
                  static_cast<size_t>(n) * k * sizeof(uint64_t)) ? 0 : -EPIPE;
}

int ps_graph_set_feat(void* client, uint32_t table, const uint64_t* ids,
                      int n, const float* feats, int dim) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  uint32_t nfloats = static_cast<uint32_t>(n) * dim;
  if (!send_header(c->fd_, kGraphSetFeat, table, n) ||
      !send_all(c->fd_, ids, n * sizeof(uint64_t)) ||
      !send_u32(c->fd_, nfloats) ||
      !send_all(c->fd_, feats, static_cast<size_t>(nfloats) * sizeof(float)))
    return -EPIPE;
  int64_t status;
  return recv_i64(c->fd_, &status) ? static_cast<int>(status) : -EPIPE;
}

int ps_graph_get_feat(void* client, uint32_t table, const uint64_t* ids,
                      int n, float* out, int dim) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  if (!send_header(c->fd_, kGraphGetFeat, table, n) ||
      !send_all(c->fd_, ids, n * sizeof(uint64_t)))
    return -EPIPE;
  int64_t status;
  if (!recv_i64(c->fd_, &status)) return -EPIPE;
  if (status != 0) return static_cast<int>(status);
  return recv_all(c->fd_, out, static_cast<size_t>(n) * dim * sizeof(float))
             ? 0 : -EPIPE;
}

static int save_load_impl(void* client, uint8_t cmd, const char* path) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  uint32_t len = static_cast<uint32_t>(strlen(path));
  if (!send_header(c->fd_, cmd, 0, 0) || !send_u32(c->fd_, len) ||
      !send_all(c->fd_, path, len))
    return -EPIPE;
  int64_t status;
  return recv_i64(c->fd_, &status) ? static_cast<int>(status) : -EPIPE;
}

int ps_save(void* client, const char* path) { return save_load_impl(client, kSave, path); }
int ps_load(void* client, const char* path) { return save_load_impl(client, kLoad, path); }

int ps_barrier(void* client, uint32_t generation, int world) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  if (!send_header(c->fd_, kBarrier, generation, world)) return -EPIPE;
  int64_t status;
  return recv_i64(c->fd_, &status) ? static_cast<int>(status) : -EPIPE;
}

int ps_stop_server(void* client) {
  auto* c = static_cast<PsClient*>(client);
  std::lock_guard<std::mutex> lk(c->mu_);
  if (!send_header(c->fd_, kStop, 0, 0)) return -EPIPE;
  int64_t status;
  return recv_i64(c->fd_, &status) ? static_cast<int>(status) : -EPIPE;
}

}  // extern "C"
