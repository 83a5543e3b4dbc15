// The kernel launches of one library, for its callers' per-call counts.
// Every launch site calls note_launch() right after its <<<...>>>, and the
// library's aaclip_kernels_launched() gives the total since it was loaded.
// Each source is built alone into its own shared library and includes this
// header once, so each library holds its own count.
#pragma once

#include <atomic>

namespace {

std::atomic<long long> g_kernels_launched{0};

inline void note_launch() {
  g_kernels_launched.fetch_add(1, std::memory_order_relaxed);
}

}  // namespace

extern "C" long long aaclip_kernels_launched() {
  return g_kernels_launched.load(std::memory_order_relaxed);
}
