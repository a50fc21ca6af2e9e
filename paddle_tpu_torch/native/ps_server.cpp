// Native parameter server for giant embedding tables.
//
// TPU-native analog of the reference PS runtime: sparse pull/push with
// server-side optimizer (operators/distributed/parameter_prefetch.cc,
// listen_and_serv_op.cc per-grad optimize blocks), worker liveness
// tracking (operators/distributed/heart_beat_monitor.h:54), barriers
// (send_barrier_op/fetch_barrier_op) and checkpoint notify
// (checkpoint_notify_op.cc) — re-designed as one small C++ TCP service:
// the XLA graph never sees the table, workers pull the rows they need
// into a dense feed and push the rows' gradients back after the step
// (DownpourWorker PullSparse/PushSparse pattern, downpour_worker.cc).
//
// Exposed C ABI (ctypes):
//   server: pt_ps_serve(port, num_tables, dim, opt, lr_is_client_side...)
//   client: pt_ps_connect/pull/push/barrier/heartbeat/save/load/stats/
//           stop/disconnect
//
// Wire protocol (little-endian):
//   request : u8 op | u32 table | u64 n | payload
//   response: u8 status(0=ok) | payload
#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

enum Op : uint8_t {
  PULL = 1,
  PUSH = 2,
  BARRIER = 3,
  HEARTBEAT = 4,
  SAVE = 5,
  LOAD = 6,
  STATS = 7,
  STOP = 9,
};

constexpr int kShards = 64;

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct Shard {
  std::mutex mu;
  std::unordered_map<int64_t, std::vector<float>> rows;
  std::unordered_map<int64_t, std::vector<float>> accum;  // adagrad
};

struct Table {
  uint32_t dim = 0;
  Shard shards[kShards];
};

struct Server {
  std::vector<std::unique_ptr<Table>> tables;
  uint32_t dim;
  std::string optimizer;  // "sgd" | "adagrad"
  float init_range;
  uint64_t seed;
  uint32_t num_workers;
  int64_t lost_timeout_ms;
  std::atomic<bool> stop{false};

  // heartbeat book-keeping (HeartBeatMonitor parity)
  std::mutex hb_mu;
  std::unordered_map<uint32_t, int64_t> last_beat_ms;

  // barrier
  std::mutex bar_mu;
  std::condition_variable bar_cv;
  uint64_t bar_generation = 0;
  uint32_t bar_count = 0;

  int listen_fd = -1;

  // open connections, so STOP can unblock threads parked in read()
  std::mutex conns_mu;
  std::vector<int> conns;
};

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

bool read_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void init_row(const Server& srv, int64_t id, std::vector<float>* row) {
  row->resize(srv.dim);
  if (srv.init_range == 0.f) {
    std::fill(row->begin(), row->end(), 0.f);
    return;
  }
  // deterministic per-id init: reproducible across restarts & servers
  uint64_t s = splitmix64(static_cast<uint64_t>(id) ^ srv.seed);
  for (uint32_t d = 0; d < srv.dim; ++d) {
    s = splitmix64(s);
    float u = static_cast<float>(s >> 11) / 9007199254740992.0f;  // [0,1)
    (*row)[d] = (2.f * u - 1.f) * srv.init_range;
  }
}

void handle_pull(Server& srv, Table& t, int fd, uint64_t n) {
  std::vector<int64_t> ids(n);
  if (!read_all(fd, ids.data(), n * sizeof(int64_t))) return;
  std::vector<float> out(n * srv.dim);
  for (uint64_t i = 0; i < n; ++i) {
    Shard& sh = t.shards[splitmix64(ids[i]) % kShards];
    std::lock_guard<std::mutex> lk(sh.mu);
    auto it = sh.rows.find(ids[i]);
    if (it == sh.rows.end()) {
      auto& row = sh.rows[ids[i]];
      init_row(srv, ids[i], &row);
      it = sh.rows.find(ids[i]);
    }
    std::memcpy(&out[i * srv.dim], it->second.data(),
                srv.dim * sizeof(float));
  }
  uint8_t ok = 0;
  write_all(fd, &ok, 1);
  write_all(fd, out.data(), out.size() * sizeof(float));
}

void handle_push(Server& srv, Table& t, int fd, uint64_t n) {
  float lr;
  if (!read_all(fd, &lr, sizeof(float))) return;
  std::vector<int64_t> ids(n);
  std::vector<float> grads(n * srv.dim);
  if (!read_all(fd, ids.data(), n * sizeof(int64_t))) return;
  if (!read_all(fd, grads.data(), grads.size() * sizeof(float))) return;
  for (uint64_t i = 0; i < n; ++i) {
    Shard& sh = t.shards[splitmix64(ids[i]) % kShards];
    std::lock_guard<std::mutex> lk(sh.mu);
    auto& row = sh.rows[ids[i]];
    if (row.empty()) init_row(srv, ids[i], &row);
    const float* g = &grads[i * srv.dim];
    if (srv.optimizer == "adagrad") {
      auto& acc = sh.accum[ids[i]];
      if (acc.empty()) acc.assign(srv.dim, 0.f);
      for (uint32_t d = 0; d < srv.dim; ++d) {
        acc[d] += g[d] * g[d];
        row[d] -= lr * g[d] / (std::sqrt(acc[d]) + 1e-6f);
      }
    } else {  // sgd
      for (uint32_t d = 0; d < srv.dim; ++d) row[d] -= lr * g[d];
    }
  }
  uint8_t ok = 0;
  write_all(fd, &ok, 1);
}

void handle_barrier(Server& srv, int fd) {
  uint32_t worker;
  if (!read_all(fd, &worker, sizeof(worker))) return;
  {
    std::unique_lock<std::mutex> lk(srv.bar_mu);
    uint64_t gen = srv.bar_generation;
    if (++srv.bar_count >= srv.num_workers) {
      srv.bar_count = 0;
      ++srv.bar_generation;
      srv.bar_cv.notify_all();
    } else {
      srv.bar_cv.wait(lk, [&] {
        return srv.bar_generation != gen || srv.stop.load();
      });
    }
  }
  uint8_t ok = 0;
  write_all(fd, &ok, 1);
}

void handle_save(Server& srv, int fd) {
  uint32_t len;
  if (!read_all(fd, &len, sizeof(len))) return;
  std::string path(len, '\0');
  if (!read_all(fd, path.data(), len)) return;
  std::ofstream f(path, std::ios::binary);
  uint8_t status = f ? 0 : 1;
  if (f) {
    uint32_t ntab = srv.tables.size();
    f.write(reinterpret_cast<const char*>(&ntab), sizeof(ntab));
    f.write(reinterpret_cast<const char*>(&srv.dim), sizeof(srv.dim));
    for (auto& tp : srv.tables) {
      uint64_t total = 0;
      for (auto& sh : tp->shards) {
        std::lock_guard<std::mutex> lk(sh.mu);
        total += sh.rows.size();
      }
      f.write(reinterpret_cast<const char*>(&total), sizeof(total));
      for (auto& sh : tp->shards) {
        std::lock_guard<std::mutex> lk(sh.mu);
        for (auto& kv : sh.rows) {
          f.write(reinterpret_cast<const char*>(&kv.first),
                  sizeof(int64_t));
          f.write(reinterpret_cast<const char*>(kv.second.data()),
                  srv.dim * sizeof(float));
        }
      }
    }
    // acknowledge only a file that is on disk whole: close (flush)
    // first, then read the stream's state, so a failed write answers 1
    f.close();
    status = f ? 0 : 1;
  }
  write_all(fd, &status, 1);
}

void handle_load(Server& srv, int fd) {
  uint32_t len;
  if (!read_all(fd, &len, sizeof(len))) return;
  std::string path(len, '\0');
  if (!read_all(fd, path.data(), len)) return;
  std::ifstream f(path, std::ios::binary);
  uint8_t status = 0;
  uint32_t ntab = 0, dim = 0;
  if (!f || !f.read(reinterpret_cast<char*>(&ntab), sizeof(ntab)) ||
      !f.read(reinterpret_cast<char*>(&dim), sizeof(dim)) ||
      ntab != srv.tables.size() || dim != srv.dim) {
    status = 1;
  } else {
    for (auto& tp : srv.tables) {
      uint64_t total;
      f.read(reinterpret_cast<char*>(&total), sizeof(total));
      for (uint64_t i = 0; i < total; ++i) {
        int64_t id;
        f.read(reinterpret_cast<char*>(&id), sizeof(id));
        std::vector<float> row(srv.dim);
        f.read(reinterpret_cast<char*>(row.data()),
               srv.dim * sizeof(float));
        Shard& sh = tp->shards[splitmix64(id) % kShards];
        std::lock_guard<std::mutex> lk(sh.mu);
        sh.rows[id] = std::move(row);
      }
    }
    if (!f) status = 1;
  }
  write_all(fd, &status, 1);
}

void handle_stats(Server& srv, int fd) {
  uint64_t rows = 0;
  for (auto& tp : srv.tables)
    for (auto& sh : tp->shards) {
      std::lock_guard<std::mutex> lk(sh.mu);
      rows += sh.rows.size();
    }
  uint32_t alive = 0, lost = 0;
  {
    std::lock_guard<std::mutex> lk(srv.hb_mu);
    int64_t now = now_ms();
    for (auto& kv : srv.last_beat_ms) {
      if (now - kv.second > srv.lost_timeout_ms)
        ++lost;  // LostWorkerMonitor parity (heart_beat_monitor.h:104)
      else
        ++alive;
    }
  }
  uint8_t ok = 0;
  write_all(fd, &ok, 1);
  write_all(fd, &rows, sizeof(rows));
  write_all(fd, &alive, sizeof(alive));
  write_all(fd, &lost, sizeof(lost));
}

void serve_conn(Server* srv, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  {
    std::lock_guard<std::mutex> lk(srv->conns_mu);
    srv->conns.push_back(fd);
  }
  while (!srv->stop.load()) {
    uint8_t op;
    uint32_t table;
    uint64_t n;
    if (!read_all(fd, &op, 1)) break;
    if (!read_all(fd, &table, sizeof(table))) break;
    if (!read_all(fd, &n, sizeof(n))) break;
    if (op == PULL || op == PUSH) {
      if (table >= srv->tables.size()) break;
      Table& t = *srv->tables[table];
      if (op == PULL)
        handle_pull(*srv, t, fd, n);
      else
        handle_push(*srv, t, fd, n);
    } else if (op == BARRIER) {
      handle_barrier(*srv, fd);
    } else if (op == HEARTBEAT) {
      uint32_t worker;
      if (!read_all(fd, &worker, sizeof(worker))) break;
      {
        std::lock_guard<std::mutex> lk(srv->hb_mu);
        srv->last_beat_ms[worker] = now_ms();
      }
      uint8_t ok = 0;
      write_all(fd, &ok, 1);
    } else if (op == SAVE) {
      handle_save(*srv, fd);
    } else if (op == LOAD) {
      handle_load(*srv, fd);
    } else if (op == STATS) {
      handle_stats(*srv, fd);
    } else if (op == STOP) {
      uint8_t ok = 0;
      write_all(fd, &ok, 1);
      srv->stop.store(true);
      srv->bar_cv.notify_all();
      // unblock accept() and every thread parked in read()
      ::shutdown(srv->listen_fd, SHUT_RDWR);
      {
        std::lock_guard<std::mutex> lk(srv->conns_mu);
        for (int other : srv->conns)
          if (other != fd) ::shutdown(other, SHUT_RDWR);
      }
      break;
    } else {
      break;
    }
  }
  {
    std::lock_guard<std::mutex> lk(srv->conns_mu);
    srv->conns.erase(std::find(srv->conns.begin(), srv->conns.end(), fd));
  }
  ::close(fd);
}

}  // namespace

extern "C" {

// Blocking server loop; returns 0 on clean STOP.
int pt_ps_serve(int port, uint32_t num_tables, uint32_t dim,
                const char* optimizer, float init_range, uint64_t seed,
                uint32_t num_workers, int64_t lost_timeout_ms) {
  Server srv;
  srv.dim = dim;
  srv.optimizer = optimizer ? optimizer : "sgd";
  srv.init_range = init_range;
  srv.seed = seed;
  srv.num_workers = num_workers == 0 ? 1 : num_workers;
  srv.lost_timeout_ms = lost_timeout_ms;
  for (uint32_t i = 0; i < num_tables; ++i) {
    srv.tables.emplace_back(new Table());
    srv.tables.back()->dim = dim;
  }
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return 1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return 2;
  }
  if (::listen(fd, 128) != 0) {
    ::close(fd);
    return 3;
  }
  srv.listen_fd = fd;
  std::vector<std::thread> threads;
  while (!srv.stop.load()) {
    int cfd = ::accept(fd, nullptr, nullptr);
    if (cfd < 0) {
      if (srv.stop.load()) break;
      continue;
    }
    threads.emplace_back(serve_conn, &srv, cfd);
  }
  for (auto& th : threads) th.join();
  ::close(fd);
  return 0;
}

struct ClientHandle {
  int fd;
  uint32_t worker;
  std::mutex mu;
};

void* pt_ps_connect(const char* host, int port, uint32_t worker_id) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
      0) {
    ::close(fd);
    return nullptr;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* h = new ClientHandle();
  h->fd = fd;
  h->worker = worker_id;
  return h;
}

static bool send_header(ClientHandle* h, uint8_t op, uint32_t table,
                        uint64_t n) {
  return write_all(h->fd, &op, 1) &&
         write_all(h->fd, &table, sizeof(table)) &&
         write_all(h->fd, &n, sizeof(n));
}

static int read_status(ClientHandle* h) {
  uint8_t st;
  if (!read_all(h->fd, &st, 1)) return -1;
  return st;
}

int pt_ps_pull(void* hv, uint32_t table, const int64_t* ids, uint64_t n,
               uint32_t dim, float* out) {
  auto* h = static_cast<ClientHandle*>(hv);
  std::lock_guard<std::mutex> lk(h->mu);
  if (!send_header(h, PULL, table, n)) return -1;
  if (!write_all(h->fd, ids, n * sizeof(int64_t))) return -1;
  int st = read_status(h);
  if (st != 0) return st;
  if (!read_all(h->fd, out, n * dim * sizeof(float))) return -1;
  return 0;
}

int pt_ps_push(void* hv, uint32_t table, const int64_t* ids, uint64_t n,
               uint32_t dim, const float* grads, float lr) {
  auto* h = static_cast<ClientHandle*>(hv);
  std::lock_guard<std::mutex> lk(h->mu);
  if (!send_header(h, PUSH, table, n)) return -1;
  if (!write_all(h->fd, &lr, sizeof(float))) return -1;
  if (!write_all(h->fd, ids, n * sizeof(int64_t))) return -1;
  if (!write_all(h->fd, grads, n * dim * sizeof(float))) return -1;
  return read_status(h);
}

int pt_ps_barrier(void* hv) {
  auto* h = static_cast<ClientHandle*>(hv);
  std::lock_guard<std::mutex> lk(h->mu);
  if (!send_header(h, BARRIER, 0, 0)) return -1;
  if (!write_all(h->fd, &h->worker, sizeof(h->worker))) return -1;
  return read_status(h);
}

int pt_ps_heartbeat(void* hv) {
  auto* h = static_cast<ClientHandle*>(hv);
  std::lock_guard<std::mutex> lk(h->mu);
  if (!send_header(h, HEARTBEAT, 0, 0)) return -1;
  if (!write_all(h->fd, &h->worker, sizeof(h->worker))) return -1;
  return read_status(h);
}

static int path_op(ClientHandle* h, uint8_t op, const char* path) {
  std::lock_guard<std::mutex> lk(h->mu);
  if (!send_header(h, op, 0, 0)) return -1;
  uint32_t len = std::strlen(path);
  if (!write_all(h->fd, &len, sizeof(len))) return -1;
  if (!write_all(h->fd, path, len)) return -1;
  return read_status(h);
}

int pt_ps_save(void* hv, const char* path) {
  return path_op(static_cast<ClientHandle*>(hv), SAVE, path);
}

int pt_ps_load(void* hv, const char* path) {
  return path_op(static_cast<ClientHandle*>(hv), LOAD, path);
}

int pt_ps_stats(void* hv, uint64_t* rows, uint32_t* alive,
                uint32_t* lost) {
  auto* h = static_cast<ClientHandle*>(hv);
  std::lock_guard<std::mutex> lk(h->mu);
  if (!send_header(h, STATS, 0, 0)) return -1;
  int st = read_status(h);
  if (st != 0) return st;
  if (!read_all(h->fd, rows, sizeof(*rows))) return -1;
  if (!read_all(h->fd, alive, sizeof(*alive))) return -1;
  if (!read_all(h->fd, lost, sizeof(*lost))) return -1;
  return 0;
}

int pt_ps_stop(void* hv) {
  auto* h = static_cast<ClientHandle*>(hv);
  std::lock_guard<std::mutex> lk(h->mu);
  if (!send_header(h, STOP, 0, 0)) return -1;
  return read_status(h);
}

void pt_ps_disconnect(void* hv) {
  auto* h = static_cast<ClientHandle*>(hv);
  ::close(h->fd);
  delete h;
}

}  // extern "C"
