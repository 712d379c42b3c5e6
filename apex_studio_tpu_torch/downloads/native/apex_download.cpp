// apex_download — native multi-connection HTTP downloader.
//
// Counterpart of the reference's Rust extension (apps/api/rust/apex_download_rs,
// pyo3 + reqwest + tokio: ranged multi-connection downloads with progress
// callbacks into Python). This build is C++: libcurl is dlopen'd at runtime
// (the image ships libcurl.so.4 but no dev headers, so the small stable subset
// of the easy API is declared here), one thread per connection, ranged GETs
// pwrite'd into a preallocated file, lock-free byte counters polled by Python.
//
// Exposed C ABI (consumed via ctypes in downloads/native.py):
//   int64_t apex_probe(const char* url, const char* headers, int* accepts_ranges);
//   int     apex_download(const char* url, const char* dest, int connections,
//                         const char* headers, int64_t* progress_out,
//                         char* err, int err_len);
//
// Build: g++ -O2 -shared -fPIC -o libapexdl.so apex_download.cpp -ldl -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <dlfcn.h>
#include <fcntl.h>
#include <unistd.h>

// ---- minimal libcurl ABI ------------------------------------------------------

typedef void CURL;
typedef int CURLcode;  // CURLE_OK == 0

// Stable option codes from curl.h (long=0, objectpoint=10000, off_t=30000 bases).
enum {
  CURLOPT_WRITEDATA = 10001,
  CURLOPT_URL = 10002,
  CURLOPT_RANGE = 10007,
  CURLOPT_ERRORBUFFER = 10010,
  CURLOPT_WRITEFUNCTION = 20011,
  CURLOPT_NOBODY = 44,
  CURLOPT_FOLLOWLOCATION = 52,
  CURLOPT_NOSIGNAL = 99,
  CURLOPT_HTTPHEADER = 10023,
  CURLOPT_USERAGENT = 10018,
  CURLOPT_LOW_SPEED_LIMIT = 19,
  CURLOPT_LOW_SPEED_TIME = 20,
  CURLOPT_CONNECTTIMEOUT = 78,
  CURLOPT_ACCEPT_ENCODING = 10102,
};
enum {
  CURLINFO_RESPONSE_CODE = 0x200000 + 2,
  CURLINFO_CONTENT_LENGTH_DOWNLOAD_T = 0x600000 + 15,
};

struct CurlApi {
  CURLcode (*global_init)(long);
  CURL* (*easy_init)();
  CURLcode (*easy_setopt)(CURL*, int, ...);
  CURLcode (*easy_perform)(CURL*);
  void (*easy_cleanup)(CURL*);
  CURLcode (*easy_getinfo)(CURL*, int, ...);
  void* (*slist_append)(void*, const char*);
  void (*slist_free_all)(void*);
  bool ok = false;
};

static CurlApi& curl_api() {
  static CurlApi api = [] {
    CurlApi a;
    // RTLD_LOCAL + DEEPBIND: libcurl must resolve its TLS/crypto deps against
    // its own libraries, NOT against whatever the host process already loaded
    // (jax/grpc ship boringssl — OpenSSL-symbol interposition segfaults).
    const int flags = RTLD_NOW | RTLD_LOCAL | RTLD_DEEPBIND;
    void* h = dlopen("libcurl.so.4", flags);
    if (!h) h = dlopen("libcurl-gnutls.so.4", flags);
    if (!h) h = dlopen("libcurl.so", flags);
    if (!h) return a;
    a.global_init = (CURLcode(*)(long))dlsym(h, "curl_global_init");
    a.easy_init = (CURL * (*)()) dlsym(h, "curl_easy_init");
    a.easy_setopt = (CURLcode(*)(CURL*, int, ...))dlsym(h, "curl_easy_setopt");
    a.easy_perform = (CURLcode(*)(CURL*))dlsym(h, "curl_easy_perform");
    a.easy_cleanup = (void (*)(CURL*))dlsym(h, "curl_easy_cleanup");
    a.easy_getinfo = (CURLcode(*)(CURL*, int, ...))dlsym(h, "curl_easy_getinfo");
    a.slist_append = (void* (*)(void*, const char*))dlsym(h, "curl_slist_append");
    a.slist_free_all = (void (*)(void*))dlsym(h, "curl_slist_free_all");
    a.ok = a.easy_init && a.easy_setopt && a.easy_perform && a.easy_cleanup &&
           a.easy_getinfo && a.slist_append && a.slist_free_all;
    // curl_easy_init's implicit global init is NOT thread-safe; segments run
    // on concurrent threads, so do the one-time global init here (inside the
    // thread-safe static initializer). 3 = CURL_GLOBAL_ALL.
    if (a.ok && a.global_init) a.global_init(3L);
    return a;
  }();
  return api;
}

static void* build_headers(CurlApi& api, const char* headers) {
  if (!headers || !*headers) return nullptr;
  void* list = nullptr;
  std::string all(headers);
  size_t pos = 0;
  while (pos < all.size()) {
    size_t nl = all.find('\n', pos);
    if (nl == std::string::npos) nl = all.size();
    std::string line = all.substr(pos, nl - pos);
    if (!line.empty()) list = api.slist_append(list, line.c_str());
    pos = nl + 1;
  }
  return list;
}

// ---- probe ---------------------------------------------------------------------

struct SinkCtx {
  size_t seen = 0;
};

static size_t sink_cb(char*, size_t size, size_t nmemb, void* userp) {
  auto* ctx = static_cast<SinkCtx*>(userp);
  ctx->seen += size * nmemb;
  return size * nmemb;
}

extern "C" int64_t apex_probe(const char* url, const char* headers,
                              int* accepts_ranges) {
  CurlApi& api = curl_api();
  if (!api.ok) return -2;
  CURL* h = api.easy_init();
  if (!h) return -2;
  SinkCtx sink;
  void* hdrs = build_headers(api, headers);
  api.easy_setopt(h, CURLOPT_URL, url);
  api.easy_setopt(h, CURLOPT_NOBODY, 1L);
  api.easy_setopt(h, CURLOPT_FOLLOWLOCATION, 1L);
  api.easy_setopt(h, CURLOPT_NOSIGNAL, 1L);
  api.easy_setopt(h, CURLOPT_CONNECTTIMEOUT, 30L);
  api.easy_setopt(h, CURLOPT_USERAGENT, "apex-studio-tpu/0.1");
  api.easy_setopt(h, CURLOPT_WRITEFUNCTION, sink_cb);
  api.easy_setopt(h, CURLOPT_WRITEDATA, &sink);
  if (hdrs) api.easy_setopt(h, CURLOPT_HTTPHEADER, hdrs);
  CURLcode rc = api.easy_perform(h);
  int64_t length = -1;
  long code = 0;
  if (rc == 0) {
    api.easy_getinfo(h, CURLINFO_RESPONSE_CODE, &code);
    int64_t cl = -1;
    api.easy_getinfo(h, CURLINFO_CONTENT_LENGTH_DOWNLOAD_T, &cl);
    if (code >= 200 && code < 300) length = cl;
  }
  if (accepts_ranges) *accepts_ranges = length > 0 ? 1 : 0;
  if (hdrs) api.slist_free_all(hdrs);
  api.easy_cleanup(h);
  return rc == 0 ? length : -1;
}

// ---- ranged download -------------------------------------------------------------

struct SegmentCtx {
  int fd;
  int64_t offset;
  std::atomic<int64_t>* progress;
};

static size_t write_cb(char* ptr, size_t size, size_t nmemb, void* userp) {
  auto* ctx = static_cast<SegmentCtx*>(userp);
  size_t n = size * nmemb;
  ssize_t written = pwrite(ctx->fd, ptr, n, ctx->offset);
  if (written != (ssize_t)n) return 0;  // abort transfer
  ctx->offset += written;
  ctx->progress->fetch_add(written, std::memory_order_relaxed);
  return n;
}

static int fetch_range(const char* url, const char* headers, int fd,
                       int64_t begin, int64_t end /*exclusive; -1 = whole file*/,
                       std::atomic<int64_t>* progress, std::string* err) {
  CurlApi& api = curl_api();
  CURL* h = api.easy_init();
  if (!h) {
    *err = "curl_easy_init failed";
    return 1;
  }
  SegmentCtx ctx{fd, begin, progress};
  char errbuf[256] = {0};
  void* hdrs = build_headers(api, headers);
  api.easy_setopt(h, CURLOPT_URL, url);
  api.easy_setopt(h, CURLOPT_FOLLOWLOCATION, 1L);
  api.easy_setopt(h, CURLOPT_NOSIGNAL, 1L);
  api.easy_setopt(h, CURLOPT_CONNECTTIMEOUT, 30L);
  api.easy_setopt(h, CURLOPT_LOW_SPEED_LIMIT, 1024L);
  api.easy_setopt(h, CURLOPT_LOW_SPEED_TIME, 60L);
  api.easy_setopt(h, CURLOPT_USERAGENT, "apex-studio-tpu/0.1");
  api.easy_setopt(h, CURLOPT_WRITEFUNCTION, write_cb);
  api.easy_setopt(h, CURLOPT_WRITEDATA, &ctx);
  api.easy_setopt(h, CURLOPT_ERRORBUFFER, errbuf);
  api.easy_setopt(h, CURLOPT_ACCEPT_ENCODING, "identity");
  if (hdrs) api.easy_setopt(h, CURLOPT_HTTPHEADER, hdrs);
  char range[64];
  if (end >= 0) {
    snprintf(range, sizeof(range), "%lld-%lld", (long long)begin, (long long)(end - 1));
    api.easy_setopt(h, CURLOPT_RANGE, range);
  }
  CURLcode rc = api.easy_perform(h);
  long code = 0;
  api.easy_getinfo(h, CURLINFO_RESPONSE_CODE, &code);
  if (hdrs) api.slist_free_all(hdrs);
  api.easy_cleanup(h);
  if (rc != 0) {
    *err = errbuf[0] ? errbuf : "curl transfer failed";
    return 2;
  }
  if (code >= 400) {
    *err = "HTTP error " + std::to_string(code);
    return 3;
  }
  return 0;
}

extern "C" int apex_download(const char* url, const char* dest, int connections,
                             const char* headers, int64_t* progress_out,
                             char* err_out, int err_len) {
  CurlApi& api = curl_api();
  if (!api.ok) {
    snprintf(err_out, err_len, "libcurl unavailable");
    return 10;
  }
  int accepts = 0;
  int64_t total = apex_probe(url, headers, &accepts);
  if (progress_out) progress_out[1] = total > 0 ? total : -1;

  int fd = open(dest, O_CREAT | O_WRONLY | O_TRUNC, 0644);
  if (fd < 0) {
    snprintf(err_out, err_len, "cannot open %s", dest);
    return 11;
  }
  std::atomic<int64_t> progress{0};
  std::string first_err;
  int status = 0;

  if (total <= 0 || connections <= 1) {
    // Unknown size or single stream: one connection, no Range header.
    status = fetch_range(url, headers, fd, 0, -1, &progress, &first_err);
    if (progress_out) progress_out[0] = progress.load();
  } else {
    if (ftruncate(fd, total) != 0) { /* best effort preallocation */ }
    int n = connections;
    int64_t seg = (total + n - 1) / n;
    std::vector<std::thread> threads;
    std::vector<int> results(n, 0);
    std::vector<std::string> errs(n);
    for (int i = 0; i < n; i++) {
      int64_t begin = (int64_t)i * seg;
      int64_t end = begin + seg;
      if (end > total) end = total;
      if (begin >= end) break;
      threads.emplace_back([=, &progress, &results, &errs] {
        results[i] = fetch_range(url, headers, fd, begin, end, &progress, &errs[i]);
      });
    }
    // Poll progress into progress_out while segments run.
    std::atomic<bool> done{false};
    std::thread poller([&] {
      while (!done.load()) {
        if (progress_out) progress_out[0] = progress.load();
        usleep(50 * 1000);
      }
      if (progress_out) progress_out[0] = progress.load();
    });
    for (auto& t : threads) t.join();
    done.store(true);
    poller.join();
    for (size_t i = 0; i < results.size(); i++) {
      if (results[i] != 0 && status == 0) {
        status = results[i];
        first_err = errs[i];
      }
    }
  }
  close(fd);
  if (status != 0) {
    snprintf(err_out, err_len, "%s", first_err.c_str());
    unlink(dest);
  }
  return status;
}
