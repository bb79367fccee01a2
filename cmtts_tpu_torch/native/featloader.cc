// Copied from native/featloader.cc so that the PyTorch port carries its own
// source; cmtts_tpu_torch/data/native_loader.py builds it with g++ into
// build/ under a name hashed from this file and the flags.
//
// Native feature loader: parallel .npy reading for the training input
// pipeline.
//
// The training loop consumes thousands of small per-utterance feature
// files (mel/pitch/f0/energy/duration/mel2ph/cwt, SURVEY §2.4); Python's
// np.load is serial and GIL-bound.  This library loads a whole batch's
// files on a thread pool into one arena and hands Python
// (pointer, dtype, shape) views over a C ABI (ctypes — no pybind11 in
// this image).
//
// API (stable C):
//   void* fl_create(int n_threads);
//   void  fl_destroy(void* h);
//   long  fl_submit(void* h, const char** paths, int n);   // async job
//   int   fl_wait(void* h, long job, FLItem* items, int max_items);
//   void  fl_release(void* h, long job);                   // free arena
//
// dtype codes: 0 f32, 1 f64, 2 i32, 3 i64, 4 i16, 5 u8, -1 unsupported.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

struct FLItem {
  const void* data;
  int64_t nbytes;
  int32_t dtype;
  int32_t ndim;
  int64_t shape[8];
  int32_t ok;  // 1 loaded, 0 failed
  int32_t fortran;  // 1 if stored column-major
};

}  // extern "C"

namespace {

struct Loaded {
  std::vector<char> payload;
  int32_t dtype = -1;
  std::vector<int64_t> shape;
  bool ok = false;
  bool fortran = false;
};

int32_t dtype_code(const std::string& descr) {
  // little-endian or byte-order-agnostic numpy descrs
  if (descr == "<f4" || descr == "|f4" || descr == "=f4") return 0;
  if (descr == "<f8" || descr == "=f8") return 1;
  if (descr == "<i4" || descr == "=i4") return 2;
  if (descr == "<i8" || descr == "=i8") return 3;
  if (descr == "<i2" || descr == "=i2") return 4;
  if (descr == "|u1") return 5;
  return -1;
}

// minimal .npy v1/v2 parser (format spec: numpy/lib/format.py)
bool load_npy(const std::string& path, Loaded* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 ||
      std::memcmp(magic, "\x93NUMPY", 6) != 0) {
    std::fclose(f);
    return false;
  }
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (std::fread(b, 1, 2, f) != 2) { std::fclose(f); return false; }
    header_len = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (std::fread(b, 1, 4, f) != 4) { std::fclose(f); return false; }
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
  }
  std::string header(header_len, '\0');
  if (std::fread(&header[0], 1, header_len, f) != header_len) {
    std::fclose(f);
    return false;
  }

  auto find_value = [&](const char* key) -> std::string {
    size_t k = header.find(key);
    if (k == std::string::npos) return "";
    size_t c = header.find(':', k);
    if (c == std::string::npos) return "";
    size_t e = c + 1;
    // value runs to the matching ',' at depth 0 or to '}'
    int depth = 0;
    size_t start = e;
    for (; e < header.size(); ++e) {
      char ch = header[e];
      if (ch == '(' || ch == '[') depth++;
      if (ch == ')' || ch == ']') depth--;
      if ((ch == ',' && depth == 0) || ch == '}') break;
    }
    return header.substr(start, e - start);
  };

  std::string descr = find_value("'descr'");
  // strip quotes/spaces
  std::string d;
  for (char ch : descr)
    if (ch != '\'' && ch != ' ' && ch != '"') d.push_back(ch);
  out->dtype = dtype_code(d);

  std::string fortran = find_value("'fortran_order'");
  out->fortran = fortran.find("True") != std::string::npos;

  std::string shape = find_value("'shape'");
  out->shape.clear();
  int64_t cur = -1;
  for (char ch : shape) {
    if (ch >= '0' && ch <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (ch - '0');
    } else if (cur >= 0) {
      out->shape.push_back(cur);
      cur = -1;
    }
  }
  if (cur >= 0) out->shape.push_back(cur);

  if (out->dtype < 0 || out->shape.size() > 8) {
    std::fclose(f);
    return false;
  }

  static const int64_t isize[6] = {4, 8, 4, 8, 2, 1};
  int64_t count = 1;
  for (int64_t s : out->shape) count *= s;
  int64_t nbytes = count * isize[out->dtype];
  out->payload.resize(nbytes);
  bool ok = std::fread(out->payload.data(), 1, nbytes, f) == (size_t)nbytes;
  std::fclose(f);
  out->ok = ok;
  return ok;
}

struct Job {
  std::vector<std::string> paths;
  std::vector<Loaded> items;
  std::atomic<int> remaining{0};
  std::mutex m;
  std::condition_variable cv;
};

struct Pool {
  std::vector<std::thread> threads;
  std::queue<std::pair<Job*, int>> tasks;
  std::mutex m;
  std::condition_variable cv;
  bool stop = false;
  std::mutex jobs_m;
  std::map<long, Job*> jobs;
  long next_id = 1;

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i) {
      threads.emplace_back([this] { worker(); });
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(m);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : threads) t.join();
    for (auto& kv : jobs) delete kv.second;
  }

  void worker() {
    for (;;) {
      std::pair<Job*, int> task;
      {
        std::unique_lock<std::mutex> lk(m);
        cv.wait(lk, [this] { return stop || !tasks.empty(); });
        if (stop && tasks.empty()) return;
        task = tasks.front();
        tasks.pop();
      }
      Job* job = task.first;
      int idx = task.second;
      load_npy(job->paths[idx], &job->items[idx]);
      if (job->remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(job->m);
        job->cv.notify_all();
      }
    }
  }

  long submit(const char** paths, int n) {
    Job* job = new Job();
    job->paths.reserve(n);
    for (int i = 0; i < n; ++i) job->paths.emplace_back(paths[i]);
    job->items.resize(n);
    job->remaining.store(n);
    long id;
    {
      std::lock_guard<std::mutex> lk(jobs_m);
      id = next_id++;
      jobs[id] = job;
    }
    {
      std::lock_guard<std::mutex> lk(m);
      for (int i = 0; i < n; ++i) tasks.emplace(job, i);
    }
    cv.notify_all();
    return id;
  }

  Job* find(long id) {
    std::lock_guard<std::mutex> lk(jobs_m);
    auto it = jobs.find(id);
    return it == jobs.end() ? nullptr : it->second;
  }

  void release(long id) {
    Job* job = nullptr;
    {
      std::lock_guard<std::mutex> lk(jobs_m);
      auto it = jobs.find(id);
      if (it != jobs.end()) {
        job = it->second;
        jobs.erase(it);
      }
    }
    delete job;
  }
};

}  // namespace

extern "C" {

void* fl_create(int n_threads) {
  if (n_threads <= 0) n_threads = 4;
  return new Pool(n_threads);
}

void fl_destroy(void* h) { delete static_cast<Pool*>(h); }

long fl_submit(void* h, const char** paths, int n) {
  return static_cast<Pool*>(h)->submit(paths, n);
}

int fl_wait(void* h, long job_id, FLItem* items, int max_items) {
  Pool* pool = static_cast<Pool*>(h);
  Job* job = pool->find(job_id);
  if (!job) return -1;
  {
    std::unique_lock<std::mutex> lk(job->m);
    job->cv.wait(lk, [job] { return job->remaining.load() == 0; });
  }
  int n = (int)job->items.size();
  if (n > max_items) n = max_items;
  for (int i = 0; i < n; ++i) {
    const Loaded& it = job->items[i];
    items[i].data = it.payload.data();
    items[i].nbytes = (int64_t)it.payload.size();
    items[i].dtype = it.dtype;
    items[i].ndim = (int32_t)it.shape.size();
    for (size_t d = 0; d < it.shape.size() && d < 8; ++d)
      items[i].shape[d] = it.shape[d];
    items[i].ok = it.ok ? 1 : 0;
    items[i].fortran = it.fortran ? 1 : 0;
  }
  return n;
}

void fl_release(void* h, long job_id) {
  static_cast<Pool*>(h)->release(job_id);
}

// Copy every payload into caller-provided buffers, parallelized over the
// pool's threads (the Python-side serial memcpy was the bottleneck).
int fl_gather(void* h, long job_id, void** dests, int n) {
  Pool* pool = static_cast<Pool*>(h);
  Job* job = pool->find(job_id);
  if (!job) return -1;
  {
    std::unique_lock<std::mutex> lk(job->m);
    job->cv.wait(lk, [job] { return job->remaining.load() == 0; });
  }
  int count = (int)job->items.size();
  if (count > n) count = n;
  std::atomic<int> next{0};
  int n_threads = (int)pool->threads.size();
  std::vector<std::thread> copiers;
  for (int t = 0; t < n_threads; ++t) {
    copiers.emplace_back([&] {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= count) return;
        const Loaded& it = job->items[i];
        if (it.ok && dests[i]) {
          std::memcpy(dests[i], it.payload.data(), it.payload.size());
        }
      }
    });
  }
  for (auto& t : copiers) t.join();
  return count;
}

}  // extern "C"
