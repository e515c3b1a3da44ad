// Native key -> slot multimap for usearch_torch, a copy of the JAX
// package's usearch_tpu/native/keymap.cc.
//
// Host-side C++ re-design of the reference's flat hash multi-set
// (reference: include/usearch/index_plugins.hpp:2518-3030 —
// flat_hash_multi_set_gt): open addressing, linear probing, tombstones,
// power-of-two capacity, duplicate keys allowed when `multi`. Exposed through
// a C ABI bound with ctypes (native/keymap_native.py), which builds it with
// g++ at first use.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum State : uint8_t { EMPTY = 0, OCCUPIED = 1, TOMB = 2 };

struct Entry {
    uint64_t key;
    uint64_t slot;
};

struct KeyMap {
    std::vector<Entry> entries;
    std::vector<uint8_t> states;
    uint64_t mask = 0;       // capacity - 1
    uint64_t size = 0;       // live entries
    uint64_t occupied = 0;   // live + tombstones (for load-factor decisions)
    bool multi = false;

    explicit KeyMap(bool multi_, uint64_t capacity = 64) : multi(multi_) {
        reserve_pow2(capacity);
    }

    static uint64_t hash(uint64_t k) {
        // splitmix64 finalizer — strong enough for u64 keys
        k += 0x9E3779B97F4A7C15ull;
        k = (k ^ (k >> 30)) * 0xBF58476D1CE4E5B9ull;
        k = (k ^ (k >> 27)) * 0x94D049BB133111EBull;
        return k ^ (k >> 31);
    }

    void reserve_pow2(uint64_t capacity) {
        uint64_t cap = 64;
        while (cap < capacity) cap <<= 1;
        entries.assign(cap, Entry{0, 0});
        states.assign(cap, EMPTY);
        mask = cap - 1;
        size = 0;
        occupied = 0;
    }

    void grow_if_needed(uint64_t incoming) {
        // grow at 2/3 load, like the reference's 5/3 growth policy intent
        uint64_t cap = mask + 1;
        if ((occupied + incoming) * 3 < cap * 2) return;
        uint64_t need = (size + incoming) * 2;
        std::vector<Entry> old_e;
        std::vector<uint8_t> old_s;
        old_e.swap(entries);
        old_s.swap(states);
        uint64_t old_cap = cap;
        reserve_pow2(need < 64 ? 64 : need);
        for (uint64_t i = 0; i < old_cap; ++i)
            if (old_s[i] == OCCUPIED) insert_raw(old_e[i].key, old_e[i].slot);
    }

    void insert_raw(uint64_t key, uint64_t slot) {
        uint64_t i = hash(key) & mask;
        while (states[i] == OCCUPIED) i = (i + 1) & mask;
        if (states[i] == EMPTY) ++occupied;
        states[i] = OCCUPIED;
        entries[i] = Entry{key, slot};
        ++size;
    }

    void insert(uint64_t key, uint64_t slot) {
        grow_if_needed(1);
        insert_raw(key, slot);
    }

    template <typename Fn> void for_each_match(uint64_t key, Fn&& fn) const {
        uint64_t i = hash(key) & mask;
        while (states[i] != EMPTY) {
            if (states[i] == OCCUPIED && entries[i].key == key)
                if (!fn(i)) return;
            i = (i + 1) & mask;
        }
    }

    uint64_t count(uint64_t key) const {
        uint64_t n = 0;
        for_each_match(key, [&](uint64_t) {
            ++n;
            return true;
        });
        return n;
    }
};

}  // namespace

extern "C" {

void* km_create(int multi) { return new KeyMap(multi != 0); }

void km_destroy(void* h) { delete static_cast<KeyMap*>(h); }

uint64_t km_size(void* h) { return static_cast<KeyMap*>(h)->size; }

void km_insert_many(void* h, uint64_t const* keys, uint64_t const* slots, uint64_t n) {
    KeyMap* m = static_cast<KeyMap*>(h);
    m->grow_if_needed(n);
    for (uint64_t i = 0; i < n; ++i) m->insert_raw(keys[i], slots[i]);
}

uint64_t km_slots_of(void* h, uint64_t key, uint64_t* out, uint64_t cap) {
    KeyMap* m = static_cast<KeyMap*>(h);
    uint64_t n = 0;
    m->for_each_match(key, [&](uint64_t i) {
        if (n < cap) out[n] = m->entries[i].slot;
        ++n;
        return true;
    });
    return n;
}

uint64_t km_pop(void* h, uint64_t key, uint64_t* out, uint64_t cap) {
    KeyMap* m = static_cast<KeyMap*>(h);
    uint64_t n = 0;
    m->for_each_match(key, [&](uint64_t i) {
        if (n < cap) out[n] = m->entries[i].slot;
        m->states[i] = TOMB;
        --m->size;
        ++n;
        return true;
    });
    return n;
}

int km_contains(void* h, uint64_t key) {
    KeyMap* m = static_cast<KeyMap*>(h);
    int found = 0;
    m->for_each_match(key, [&](uint64_t) {
        found = 1;
        return false;
    });
    return found;
}

uint64_t km_count(void* h, uint64_t key) { return static_cast<KeyMap*>(h)->count(key); }

void km_contains_many(void* h, uint64_t const* keys, uint64_t n, uint8_t* out) {
    for (uint64_t i = 0; i < n; ++i) out[i] = (uint8_t)km_contains(h, keys[i]);
}

void km_count_many(void* h, uint64_t const* keys, uint64_t n, uint64_t* out) {
    KeyMap* m = static_cast<KeyMap*>(h);
    for (uint64_t i = 0; i < n; ++i) out[i] = m->count(keys[i]);
}

int km_max_key(void* h, uint64_t* out) {
    KeyMap* m = static_cast<KeyMap*>(h);
    if (m->size == 0) return 0;
    uint64_t best = 0;
    bool any = false;
    uint64_t cap = m->mask + 1;
    for (uint64_t i = 0; i < cap; ++i)
        if (m->states[i] == OCCUPIED) {
            if (!any || m->entries[i].key > best) best = m->entries[i].key;
            any = true;
        }
    *out = best;
    return any ? 1 : 0;
}

uint64_t km_keys_all(void* h, uint64_t* out, uint64_t cap) {
    // all live keys, one per entry (duplicates repeated), insertion-order-free
    KeyMap* m = static_cast<KeyMap*>(h);
    uint64_t n = 0;
    uint64_t capacity = m->mask + 1;
    for (uint64_t i = 0; i < capacity; ++i)
        if (m->states[i] == OCCUPIED) {
            if (n < cap) out[n] = m->entries[i].key;
            ++n;
        }
    return n;
}

void* km_copy(void* h) {
    KeyMap* m = static_cast<KeyMap*>(h);
    return new KeyMap(*m);
}

}  // extern "C"
