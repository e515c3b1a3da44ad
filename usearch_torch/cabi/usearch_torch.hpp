/**
 * usearch_torch C++ wrapper: the RAII/STL interface of the JAX package's
 * cpp/usearch_tpu.hpp over the port's C ABI (usearch_torch.h), mirroring
 * how the reference's C++ callers consume
 * `index_dense_t` (reference: include/usearch/index_dense.hpp:387-2227;
 * API surface per c/usearch.h). Errors become exceptions; handles are
 * move-only; results are std::vector<match_t>.
 *
 * Header-only: link against libusearch_torch.so (usearch_torch.cabi.build).
 * Runs on the card unless USEARCH_TORCH_DEVICE=cpu.
 */
#pragma once

#include <cstddef>
#include <cstdint>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "usearch_torch.h"

namespace usearch_torch {

enum class metric_kind_t {
    cos_k = usearch_metric_cos_k,
    ip_k = usearch_metric_ip_k,
    l2sq_k = usearch_metric_l2sq_k,
    haversine_k = usearch_metric_haversine_k,
    divergence_k = usearch_metric_divergence_k,
    pearson_k = usearch_metric_pearson_k,
    jaccard_k = usearch_metric_jaccard_k,
    hamming_k = usearch_metric_hamming_k,
    tanimoto_k = usearch_metric_tanimoto_k,
    sorensen_k = usearch_metric_sorensen_k,
};

enum class scalar_kind_t {
    f32_k = usearch_scalar_f32_k,
    f64_k = usearch_scalar_f64_k,
    f16_k = usearch_scalar_f16_k,
    bf16_k = usearch_scalar_bf16_k,
    i8_k = usearch_scalar_i8_k,
    b1_k = usearch_scalar_b1_k,
};

using vector_key_t = usearch_key_t;
using distance_t = usearch_distance_t;

struct index_error : std::runtime_error {
    using std::runtime_error::runtime_error;
};

namespace detail {
inline void raise_if(usearch_error_t error) {
    if (error)
        throw index_error(error);
}
} // namespace detail

struct match_t {
    vector_key_t key;
    distance_t distance;
};

struct index_config_t {
    metric_kind_t metric = metric_kind_t::cos_k;
    scalar_kind_t quantization = scalar_kind_t::f32_k;
    std::size_t dimensions = 0;
    std::size_t connectivity = 0;      // 0 = library default (16)
    std::size_t expansion_add = 0;     // 0 = default (128)
    std::size_t expansion_search = 0;  // 0 = default (64)
    bool multi = false;
};

inline std::string version() { return usearch_version(); }

/** Pairwise distance between two raw vectors (usearch_distance). */
inline distance_t distance(                                      //
    void const* a, void const* b, scalar_kind_t kind,            //
    std::size_t dimensions, metric_kind_t metric) {
    usearch_error_t error = nullptr;
    distance_t d = usearch_distance(
        a, b, static_cast<usearch_scalar_kind_t>(kind), dimensions,
        static_cast<usearch_metric_kind_t>(metric), &error);
    detail::raise_if(error);
    return d;
}

/** Move-only RAII handle over `usearch_index_t`. */
class index_t {
  public:
    index_t() = default;

    explicit index_t(index_config_t const& config) {
        usearch_init_options_t opts{};
        opts.metric_kind = static_cast<usearch_metric_kind_t>(config.metric);
        opts.quantization = static_cast<usearch_scalar_kind_t>(config.quantization);
        opts.dimensions = config.dimensions;
        opts.connectivity = config.connectivity;
        opts.expansion_add = config.expansion_add;
        opts.expansion_search = config.expansion_search;
        opts.multi = config.multi;
        usearch_error_t error = nullptr;
        handle_ = usearch_init(&opts, &error);
        detail::raise_if(error);
    }

    index_t(index_t&& other) noexcept : handle_(other.handle_) { other.handle_ = nullptr; }
    index_t& operator=(index_t&& other) noexcept {
        if (this != &other) {
            destroy_();
            handle_ = other.handle_;
            other.handle_ = nullptr;
        }
        return *this;
    }
    index_t(index_t const&) = delete;
    index_t& operator=(index_t const&) = delete;
    ~index_t() { destroy_(); }

    explicit operator bool() const noexcept { return handle_ != nullptr; }
    usearch_index_t native_handle() const noexcept { return handle_; }

    // -- capacity & metadata ------------------------------------------------
    std::size_t size() const { return call_<std::size_t>(usearch_size); }
    std::size_t capacity() const { return call_<std::size_t>(usearch_capacity); }
    std::size_t dimensions() const { return call_<std::size_t>(usearch_dimensions); }
    std::size_t connectivity() const { return call_<std::size_t>(usearch_connectivity); }
    std::size_t memory_usage() const { return call_<std::size_t>(usearch_memory_usage); }
    std::size_t serialized_length() const { return call_<std::size_t>(usearch_serialized_length); }
    std::string hardware_acceleration() const {
        usearch_error_t error = nullptr;
        char const* isa = usearch_hardware_acceleration(handle_, &error);
        detail::raise_if(error);
        return isa ? isa : "";
    }
    std::size_t expansion_add() const { return call_<std::size_t>(usearch_expansion_add); }
    std::size_t expansion_search() const { return call_<std::size_t>(usearch_expansion_search); }
    void change_expansion_add(std::size_t expansion) {
        usearch_error_t error = nullptr;
        usearch_change_expansion_add(handle_, expansion, &error);
        detail::raise_if(error);
    }
    void change_expansion_search(std::size_t expansion) {
        usearch_error_t error = nullptr;
        usearch_change_expansion_search(handle_, expansion, &error);
        detail::raise_if(error);
    }
    void reserve(std::size_t capacity) {
        usearch_error_t error = nullptr;
        usearch_reserve(handle_, capacity, &error);
        detail::raise_if(error);
    }

    // -- mutation -----------------------------------------------------------
    void add(vector_key_t key, void const* vector, scalar_kind_t kind) {
        usearch_error_t error = nullptr;
        usearch_add(handle_, key, vector, static_cast<usearch_scalar_kind_t>(kind), &error);
        detail::raise_if(error);
    }
    void add(vector_key_t key, float const* vector) { add(key, vector, scalar_kind_t::f32_k); }
    void add(vector_key_t key, double const* vector) { add(key, vector, scalar_kind_t::f64_k); }
    void add(vector_key_t key, std::int8_t const* vector) { add(key, vector, scalar_kind_t::i8_k); }

    std::size_t remove(vector_key_t key) {
        usearch_error_t error = nullptr;
        std::size_t n = usearch_remove(handle_, key, &error);
        detail::raise_if(error);
        return n;
    }
    std::size_t rename(vector_key_t from, vector_key_t to) {
        usearch_error_t error = nullptr;
        std::size_t n = usearch_rename(handle_, from, to, &error);
        detail::raise_if(error);
        return n;
    }
    void clear() {
        usearch_error_t error = nullptr;
        usearch_clear(handle_, &error);
        detail::raise_if(error);
    }

    // -- lookup -------------------------------------------------------------
    bool contains(vector_key_t key) const {
        usearch_error_t error = nullptr;
        bool has = usearch_contains(handle_, key, &error);
        detail::raise_if(error);
        return has;
    }
    std::size_t count(vector_key_t key) const {
        usearch_error_t error = nullptr;
        std::size_t n = usearch_count(handle_, key, &error);
        detail::raise_if(error);
        return n;
    }
    /** Copies up to `max_vectors` vectors stored under `key` into `out`
     *  (row-major, index dimensions per row). Returns the number copied. */
    std::size_t get(vector_key_t key, void* out, std::size_t max_vectors, scalar_kind_t kind) const {
        usearch_error_t error = nullptr;
        std::size_t n = usearch_get(handle_, key, max_vectors, out,
                                    static_cast<usearch_scalar_kind_t>(kind), &error);
        detail::raise_if(error);
        return n;
    }

    // -- search ---------------------------------------------------------------
    std::vector<match_t> search(void const* query, scalar_kind_t kind, std::size_t wanted) const {
        std::vector<vector_key_t> keys(wanted);
        std::vector<distance_t> distances(wanted);
        usearch_error_t error = nullptr;
        std::size_t found = usearch_search(
            handle_, query, static_cast<usearch_scalar_kind_t>(kind), wanted,
            keys.data(), distances.data(), &error);
        detail::raise_if(error);
        return zip_(keys, distances, found);
    }
    std::vector<match_t> search(float const* query, std::size_t wanted) const {
        return search(query, scalar_kind_t::f32_k, wanted);
    }

    /** `allowed_keys` restricts results (the reference's filtered search,
     *  index_dense.hpp filtered_search / c/usearch.h:391). */
    std::vector<match_t> filtered_search(                        //
        void const* query, scalar_kind_t kind, std::size_t wanted,
        std::vector<vector_key_t> const& allowed_keys) const {
        std::vector<vector_key_t> keys(wanted);
        std::vector<distance_t> distances(wanted);
        usearch_error_t error = nullptr;
        std::size_t found = usearch_filtered_search(
            handle_, query, static_cast<usearch_scalar_kind_t>(kind), wanted,
            allowed_keys.data(), allowed_keys.size(), keys.data(), distances.data(), &error);
        detail::raise_if(error);
        return zip_(keys, distances, found);
    }

    // -- persistence ----------------------------------------------------------
    void save(std::string const& path) const {
        usearch_error_t error = nullptr;
        usearch_save(handle_, path.c_str(), &error);
        detail::raise_if(error);
    }
    void load(std::string const& path) {
        usearch_error_t error = nullptr;
        usearch_load(handle_, path.c_str(), &error);
        detail::raise_if(error);
    }
    void view(std::string const& path) {
        usearch_error_t error = nullptr;
        usearch_view(handle_, path.c_str(), &error);
        detail::raise_if(error);
    }

    /** Sniff on-disk metadata without loading (usearch_metadata). */
    static index_config_t metadata(std::string const& path) {
        usearch_init_options_t opts{};
        usearch_error_t error = nullptr;
        usearch_metadata(path.c_str(), &opts, &error);
        detail::raise_if(error);
        index_config_t config;
        config.metric = static_cast<metric_kind_t>(opts.metric_kind);
        config.quantization = static_cast<scalar_kind_t>(opts.quantization);
        config.dimensions = opts.dimensions;
        config.connectivity = opts.connectivity;
        config.expansion_add = opts.expansion_add;
        config.expansion_search = opts.expansion_search;
        config.multi = opts.multi;
        return config;
    }

  private:
    template <typename result_at>
    result_at call_(result_at (*fn)(usearch_index_t, usearch_error_t*)) const {
        usearch_error_t error = nullptr;
        result_at result = fn(handle_, &error);
        detail::raise_if(error);
        return result;
    }
    static std::vector<match_t> zip_(std::vector<vector_key_t> const& keys,
                                     std::vector<distance_t> const& distances,
                                     std::size_t found) {
        std::vector<match_t> matches(found);
        for (std::size_t i = 0; i != found; ++i)
            matches[i] = match_t{keys[i], distances[i]};
        return matches;
    }
    void destroy_() noexcept {
        if (handle_) {
            usearch_error_t error = nullptr;
            usearch_free(handle_, &error);
            handle_ = nullptr;
        }
    }

    usearch_index_t handle_ = nullptr;
};

/** Brute-force search over a raw row-major dataset; row index = key
 *  (usearch_exact_search / reference exact_search_t). */
inline void exact_search(                                                     //
    void const* dataset, std::size_t dataset_count,                          //
    void const* queries, std::size_t queries_count,                          //
    scalar_kind_t kind, std::size_t dimensions, metric_kind_t metric,        //
    std::size_t wanted, vector_key_t* keys, distance_t* distances) {
    std::size_t scalar_bytes = kind == scalar_kind_t::f64_k  ? 8
                               : kind == scalar_kind_t::f32_k ? 4
                               : kind == scalar_kind_t::f16_k || kind == scalar_kind_t::bf16_k ? 2
                                                               : 1;
    std::size_t row_bytes = dimensions * scalar_bytes;
    usearch_error_t error = nullptr;
    usearch_exact_search(
        dataset, dataset_count, row_bytes, queries, queries_count, row_bytes,
        static_cast<usearch_scalar_kind_t>(kind), dimensions,
        static_cast<usearch_metric_kind_t>(metric), wanted, /*threads=*/0,
        keys, wanted * sizeof(vector_key_t), distances, wanted * sizeof(distance_t), &error);
    detail::raise_if(error);
}

} // namespace usearch_torch
