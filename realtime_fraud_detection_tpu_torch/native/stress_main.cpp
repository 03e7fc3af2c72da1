// ThreadSanitizer stress harness for the microbatcher queue.
//
// The reference has known unguarded RMW races in its Redis sinks
// (SURVEY.md §5.2); our native data plane is instead validated under TSAN:
// build with -fsanitize=thread and run — any data race aborts with a report.
//
//   g++ -O1 -g -std=c++17 -fsanitize=thread -pthread \
//       stress_main.cpp -o stress_tsan && ./stress_tsan
//
// Exit code 0 + "OK <count>" on stdout means every record produced by the 8
// producer threads was consumed exactly once with no races detected.

#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "microbatcher.cpp"

int main() {
  const int n_threads = 8, per_thread = 2000;
  void *q = mb_create(1024, 64, 128, 1.0);

  std::vector<std::thread> producers;
  for (int t = 0; t < n_threads; ++t) {
    producers.emplace_back([q, t] {
      char buf[64];
      for (int i = 0; i < per_thread; ++i) {
        int len = std::snprintf(buf, sizeof buf, "%d:%d", t, i);
        while (mb_push(q, buf, (uint32_t)len) != 0) std::this_thread::yield();
      }
    });
  }

  std::vector<char> seen(n_threads * per_thread, 0);
  char out[64 * 128];
  uint32_t lens[128];
  long consumed = 0, dups = 0;
  while (consumed < (long)n_threads * per_thread) {
    int n = mb_next_batch(q, out, sizeof out, lens, 50);
    size_t off = 0;
    for (int i = 0; i < n; ++i) {
      std::string rec(out + off, lens[i]);
      off += lens[i];
      int tid, idx;
      std::sscanf(rec.c_str(), "%d:%d", &tid, &idx);
      int key = tid * per_thread + idx;
      if (seen[key]) ++dups;
      seen[key] = 1;
      ++consumed;
    }
  }
  for (auto &p : producers) p.join();
  mb_destroy(q);
  if (dups) {
    std::printf("FAIL dups=%ld\n", dups);
    return 1;
  }
  std::printf("OK %ld\n", consumed);
  return 0;
}
