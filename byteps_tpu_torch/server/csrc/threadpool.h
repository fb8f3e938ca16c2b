// Minimal fixed-size thread pool with an optional priority lane.
//
// Reference analog: byteps/common/thread_pool.h, used by the server engine
// (BYTEPS_SERVER_ENGINE_THREAD) to parallelize summation across keys while
// the van threads keep receiving. SubmitPriority is the
// BYTEPS_SERVER_ENABLE_SCHEDULE lane: tasks carry a priority (key id —
// lower = earlier-declared tensor = higher priority, the worker
// scheduler's own order) and pool threads drain the priority lane
// lowest-first before FIFO work.
#pragma once

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace bps {

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) {
      threads_.emplace_back([this] { Loop(); });
    }
  }

  ~ThreadPool() { Stop(); }

  void Submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (stop_) return;
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }

  // Priority lane: lowest `prio` first; FIFO within equal prio (seq).
  void SubmitPriority(uint64_t prio, std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (stop_) return;
      pq_.push_back(PTask{prio, seq_++, std::move(fn)});
      std::push_heap(pq_.begin(), pq_.end(), PTaskLater{});
    }
    cv_.notify_one();
  }

  void Stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (stop_) return;
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) {
      if (t.joinable()) t.join();
    }
  }

 private:
  struct PTask {
    uint64_t prio;
    uint64_t seq;
    std::function<void()> fn;
  };
  // "later" ordering for std::push_heap (max-heap of later-ness = min
  // task first at front)
  struct PTaskLater {
    bool operator()(const PTask& a, const PTask& b) const {
      return a.prio != b.prio ? a.prio > b.prio : a.seq > b.seq;
    }
  };

  void Loop() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk,
                 [this] { return stop_ || !q_.empty() || !pq_.empty(); });
        if (stop_ && q_.empty() && pq_.empty()) return;
        if (!pq_.empty()) {
          std::pop_heap(pq_.begin(), pq_.end(), PTaskLater{});
          fn = std::move(pq_.back().fn);
          pq_.pop_back();
        } else {
          fn = std::move(q_.front());
          q_.pop();
        }
      }
      fn();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<std::function<void()>> q_;
  std::vector<PTask> pq_;
  uint64_t seq_ = 0;
  std::vector<std::thread> threads_;
  bool stop_ = false;
};

}  // namespace bps
