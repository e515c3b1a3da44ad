/**
 * usearch_torch C ABI: the declarations of the JAX package's c/usearch_tpu.h,
 * symbol for symbol, over the PyTorch/CUDA engine `usearch_torch`. A binding
 * built against either header switches engine by the library it links:
 * -lusearch_torch in place of -lusearch_tpu.
 *
 * The implementation (lib.cpp) embeds CPython and drives `usearch_torch`;
 * one process-wide interpreter serves all indexes. `usearch_torch.cabi`
 * builds it with g++ at first use into usearch_torch/_build/cabi/.
 *
 * Device: every index and search runs on the CUDA card, unless the
 * environment variable USEARCH_TORCH_DEVICE=cpu asks for the CPU (read once,
 * when the library starts). Without a card and without that request,
 * usearch_init returns NULL and its error names the missing device; there is
 * no quiet CPU run.
 *
 * Threads: calls serialize on the GIL. When the library starts the
 * interpreter itself (a C or C++ program), every call must come from the
 * thread that made the first one; inside a Python process (ctypes) any
 * thread may call.
 */
#ifndef USEARCH_TORCH_H
#define USEARCH_TORCH_H

#ifdef __cplusplus
extern "C" {
#endif

#include <stdbool.h>
#include <stddef.h>
#include <stdint.h>

typedef void* usearch_index_t;
typedef uint64_t usearch_key_t;
typedef float usearch_distance_t;
/** Error message pointer; NULL on success. Messages are static/thread-local
 *  buffers owned by the library. */
typedef char const* usearch_error_t;

typedef enum usearch_metric_kind_t {
    usearch_metric_unknown_k = 0,
    usearch_metric_cos_k,
    usearch_metric_ip_k,
    usearch_metric_l2sq_k,
    usearch_metric_haversine_k,
    usearch_metric_divergence_k,
    usearch_metric_pearson_k,
    usearch_metric_jaccard_k,
    usearch_metric_hamming_k,
    usearch_metric_tanimoto_k,
    usearch_metric_sorensen_k,
} usearch_metric_kind_t;

typedef enum usearch_scalar_kind_t {
    usearch_scalar_unknown_k = 0,
    usearch_scalar_f32_k,
    usearch_scalar_f64_k,
    usearch_scalar_f16_k,
    usearch_scalar_bf16_k,
    usearch_scalar_i8_k,
    usearch_scalar_b1_k,
} usearch_scalar_kind_t;

/** Custom distance function: f(vector_a, vector_b) -> distance. Evaluated
 *  on the HOST per pair (same contract as the reference's CPU UDF path —
 *  reference c/usearch.h:34); the batched path on the card needs a metric
 *  written in torch operations, available through the Python
 *  `CompiledMetric` API instead. */
typedef usearch_distance_t (*usearch_metric_t)(void const*, void const*);

typedef struct usearch_init_options_t {
    usearch_metric_kind_t metric_kind;
    usearch_metric_t metric; /* optional custom metric (used when metric_kind is unknown) */
    usearch_scalar_kind_t quantization;
    size_t dimensions;
    size_t connectivity;
    size_t expansion_add;
    size_t expansion_search;
    bool multi;
} usearch_init_options_t;

char const* usearch_version(void);

usearch_index_t usearch_init(usearch_init_options_t* options, usearch_error_t* error);
void usearch_free(usearch_index_t index, usearch_error_t* error);

size_t usearch_memory_usage(usearch_index_t index, usearch_error_t* error);
char const* usearch_hardware_acceleration(usearch_index_t index, usearch_error_t* error);
size_t usearch_serialized_length(usearch_index_t index, usearch_error_t* error);

void usearch_save(usearch_index_t index, char const* path, usearch_error_t* error);
void usearch_load(usearch_index_t index, char const* path, usearch_error_t* error);
void usearch_view(usearch_index_t index, char const* path, usearch_error_t* error);
void usearch_metadata(char const* path, usearch_init_options_t* options, usearch_error_t* error);

/** Buffer-based serialization (reference c/usearch.h:195-224). `view_buffer`
 *  copies — the engine owns device/host mirrors, so no lifetime is imposed
 *  on the caller's buffer. */
void usearch_save_buffer(usearch_index_t index, void* buffer, size_t length, usearch_error_t* error);
void usearch_load_buffer(usearch_index_t index, void const* buffer, size_t length, usearch_error_t* error);
void usearch_view_buffer(usearch_index_t index, void const* buffer, size_t length, usearch_error_t* error);
void usearch_metadata_buffer(void const* buffer, size_t length, usearch_init_options_t* options,
                             usearch_error_t* error);

/** Thread-count hints: accepted for API compatibility; the card schedules
 *  the actual device parallelism (reference c/usearch.h:300-308). */
void usearch_change_threads_add(usearch_index_t index, size_t threads, usearch_error_t* error);
void usearch_change_threads_search(usearch_index_t index, size_t threads, usearch_error_t* error);

/** Switch the distance metric of a live index (reference c/usearch.h:316). */
void usearch_change_metric_kind(usearch_index_t index, usearch_metric_kind_t kind,
                                usearch_error_t* error);

/** Install a custom metric. Stateless when `state` is NULL — f(a, b);
 *  stateful otherwise — the function is INVOKED as f(a, b, state), i.e. a
 *  3-argument function cast to usearch_metric_t, exactly the reference's
 *  contract (metric_punned_t::stateful passes the state as the third
 *  argument, index_plugins.hpp:1799-1812; the reference's usearch_metric_t
 *  typedef is likewise 2-arg). Searches on such an index run HOST-side per
 *  pair, matching the reference's CPU UDF cost model. */
void usearch_change_metric(usearch_index_t index, usearch_metric_t metric, void* state,
                           usearch_metric_kind_t kind, usearch_error_t* error);

size_t usearch_size(usearch_index_t index, usearch_error_t* error);
size_t usearch_capacity(usearch_index_t index, usearch_error_t* error);
size_t usearch_dimensions(usearch_index_t index, usearch_error_t* error);
size_t usearch_connectivity(usearch_index_t index, usearch_error_t* error);
void usearch_reserve(usearch_index_t index, size_t capacity, usearch_error_t* error);

size_t usearch_expansion_add(usearch_index_t index, usearch_error_t* error);
size_t usearch_expansion_search(usearch_index_t index, usearch_error_t* error);
void usearch_change_expansion_add(usearch_index_t index, size_t expansion, usearch_error_t* error);
void usearch_change_expansion_search(usearch_index_t index, size_t expansion, usearch_error_t* error);

void usearch_add(                                                           //
    usearch_index_t index, usearch_key_t key, void const* vector,           //
    usearch_scalar_kind_t vector_kind, usearch_error_t* error);

bool usearch_contains(usearch_index_t index, usearch_key_t key, usearch_error_t* error);
size_t usearch_count(usearch_index_t index, usearch_key_t key, usearch_error_t* error);

/** Returns the number of matches; fills up to `count` keys and distances. */
size_t usearch_search(                                                      //
    usearch_index_t index, void const* query, usearch_scalar_kind_t query_kind,
    size_t count, usearch_key_t* found_keys, usearch_distance_t* found_distances,
    usearch_error_t* error);

/** Filtered variant: `allowed_keys` restricts results (NULL = no filter). */
size_t usearch_filtered_search(                                             //
    usearch_index_t index, void const* query, usearch_scalar_kind_t query_kind,
    size_t count, usearch_key_t const* allowed_keys, size_t allowed_count,
    usearch_key_t* found_keys, usearch_distance_t* found_distances,
    usearch_error_t* error);

/** Copies up to `count` vectors stored under `key` into `vectors`. */
size_t usearch_get(                                                         //
    usearch_index_t index, usearch_key_t key, size_t count, void* vectors,
    usearch_scalar_kind_t vector_kind, usearch_error_t* error);

size_t usearch_remove(usearch_index_t index, usearch_key_t key, usearch_error_t* error);
size_t usearch_rename(usearch_index_t index, usearch_key_t from, usearch_key_t to,
                      usearch_error_t* error);

usearch_distance_t usearch_distance(                                        //
    void const* vector_first, void const* vector_second,                    //
    usearch_scalar_kind_t kind, size_t dimensions,                          //
    usearch_metric_kind_t metric_kind, usearch_error_t* error);

/** Brute-force search over a raw dataset (row index = key). */
void usearch_exact_search(                                                  //
    void const* dataset, size_t dataset_count, size_t dataset_stride,       //
    void const* queries, size_t queries_count, size_t queries_stride,       //
    usearch_scalar_kind_t scalar_kind, size_t dimensions,                   //
    usearch_metric_kind_t metric_kind, size_t count, size_t threads,        //
    usearch_key_t* keys, size_t keys_stride,                                //
    usearch_distance_t* distances, size_t distances_stride,                 //
    usearch_error_t* error);

void usearch_clear(usearch_index_t index, usearch_error_t* error);

#ifdef __cplusplus
}
#endif
#endif /* USEARCH_TORCH_H */
