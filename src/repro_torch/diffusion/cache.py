"""Approximate caching store (Nirvana [4], used by the compiler pass §4.2).

Caches intermediate latents of previously generated prompts, keyed by a
cheap prompt signature.  On a hit, denoising restarts from the cached
latent at step K instead of random noise, skipping K steps.

Bounded on two axes: at most ``capacity`` prompt signatures, evicted LRU
(hits refresh recency — popular prompts stay resident), and at most
``max_steps_per_entry`` latents per signature, evicted oldest-inserted
(each latent is a full image-sized tensor, so an unbounded per-prompt
step dict would dominate memory long before the signature count did).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Tuple


def prompt_signature(prompt: str) -> frozenset:
    return frozenset(w for w in prompt.lower().split() if len(w) > 2)


def jaccard(a: frozenset, b: frozenset) -> float:
    if not a or not b:
        return 0.0
    return len(a & b) / len(a | b)


class ApproxCache:
    def __init__(self, similarity_threshold: float = 0.5, capacity: int = 1024,
                 max_steps_per_entry: int = 8) -> None:
        self.threshold = similarity_threshold
        self.capacity = capacity
        self.max_steps_per_entry = max_steps_per_entry
        # signature -> {step: latent}; both levels in LRU/insertion order
        self._entries: "OrderedDict[frozenset, OrderedDict[int, Any]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def insert(self, prompt: str, step: int, latent: Any) -> None:
        sig = prompt_signature(prompt)
        entry = self._entries.get(sig)
        if entry is None:
            while len(self._entries) >= self.capacity:
                self._entries.popitem(last=False)       # evict LRU signature
                self.evictions += 1
            entry = self._entries[sig] = OrderedDict()
        else:
            self._entries.move_to_end(sig)              # refresh recency
        entry[step] = latent
        entry.move_to_end(step)
        while len(entry) > self.max_steps_per_entry:
            entry.popitem(last=False)           # drop oldest-inserted latent
            self.evictions += 1

    def best_match(self, prompt: str) -> Optional[Tuple[frozenset, float]]:
        sig = prompt_signature(prompt)
        best, best_sim = None, 0.0
        for s in self._entries:
            sim = jaccard(sig, s)
            if sim > best_sim:
                best, best_sim = s, sim
        if best is not None and best_sim >= self.threshold:
            return best, best_sim
        return None

    def lookup(self, prompt: str, step: int) -> Optional[Any]:
        m = self.best_match(prompt)
        if m is None:
            self.misses += 1
            return None
        entry = self._entries[m[0]]
        # closest cached step at or before the requested skip depth
        steps = sorted(entry)
        usable = [s for s in steps if s <= step]
        if not usable:
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end(m[0])         # a hit keeps the entry warm
        return entry[usable[-1]]

    def would_hit(self, prompt: str) -> bool:
        return self.best_match(prompt) is not None
