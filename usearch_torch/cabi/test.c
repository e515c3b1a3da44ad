/* C ABI smoke test of usearch_torch: init/add/search/get/save/load/view
 * round trips, modeled on the reference's c/test.c; the calls of the JAX
 * package's c/test.c, over libusearch_torch.so.
 *
 *     test_c <index file path>
 *
 * Runs on the card unless USEARCH_TORCH_DEVICE=cpu. Exits 0 on success. */

#include <assert.h>
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "usearch_torch.h"

#define CHECK(expr, err)                                                       \
    do {                                                                       \
        if (!(expr)) {                                                         \
            fprintf(stderr, "FAILED: %s (%s)\n", #expr, (err) ? (err) : "");   \
            exit(1);                                                           \
        }                                                                      \
    } while (0)

/* custom metric for usearch_change_metric: host-evaluated L1 over 4 dims */
static usearch_distance_t l1_metric(void const* a, void const* b) {
    float const* x = (float const*)a;
    float const* y = (float const*)b;
    float s = 0;
    for (int i = 0; i < 4; ++i)
        s += fabsf(x[i] - y[i]);
    return s;
}

int main(int argc, char** argv) {
    if (argc != 2) {
        fprintf(stderr, "usage: %s <index file path>\n", argv[0]);
        return 2;
    }
    usearch_error_t error = NULL;
    usearch_init_options_t opts;
    memset(&opts, 0, sizeof(opts));
    opts.metric_kind = usearch_metric_l2sq_k;
    opts.quantization = usearch_scalar_f32_k;
    opts.dimensions = 4;

    usearch_index_t index = usearch_init(&opts, &error);
    CHECK(index != NULL && error == NULL, error);
    CHECK(usearch_size(index, &error) == 0, error);
    CHECK(usearch_dimensions(index, &error) == 4, error);
    char hw[64];
    snprintf(hw, sizeof(hw), "%s", usearch_hardware_acceleration(index, &error));
    CHECK(error == NULL, error);

    float v1[4] = {0.1f, 0.2f, 0.3f, 0.4f};
    float v2[4] = {0.4f, 0.3f, 0.2f, 0.1f};
    float v3[4] = {0.9f, 0.9f, 0.9f, 0.9f};
    usearch_add(index, 42, v1, usearch_scalar_f32_k, &error);
    CHECK(error == NULL, error);
    usearch_add(index, 43, v2, usearch_scalar_f32_k, &error);
    usearch_add(index, 44, v3, usearch_scalar_f32_k, &error);
    CHECK(usearch_size(index, &error) == 3, error);
    CHECK(usearch_contains(index, 42, &error), error);
    CHECK(!usearch_contains(index, 999, &error), error);
    CHECK(usearch_count(index, 43, &error) == 1, error);

    usearch_key_t keys[3];
    usearch_distance_t dists[3];
    size_t found = usearch_search(index, v1, usearch_scalar_f32_k, 3, keys, dists, &error);
    CHECK(error == NULL, error);
    CHECK(found == 3, "expected 3 matches");
    CHECK(keys[0] == 42, "self must be nearest");
    CHECK(dists[0] < 1e-5f, "self distance must be ~0");
    CHECK(dists[1] <= dists[2], "distances must ascend");

    /* filtered search */
    usearch_key_t allow[1] = {44};
    found = usearch_filtered_search(index, v1, usearch_scalar_f32_k, 3, allow, 1, keys, dists,
                                    &error);
    CHECK(found == 1 && keys[0] == 44, "filter must restrict results");

    /* get round trip */
    float out[4] = {0};
    size_t got = usearch_get(index, 42, 1, out, usearch_scalar_f32_k, &error);
    CHECK(got == 1, error);
    CHECK(fabsf(out[0] - 0.1f) < 1e-6f && fabsf(out[3] - 0.4f) < 1e-6f, "get mismatch");

    /* rename + remove */
    CHECK(usearch_rename(index, 44, 45, &error) == 1, error);
    CHECK(usearch_contains(index, 45, &error), error);
    CHECK(usearch_remove(index, 45, &error) == 1, error);
    CHECK(usearch_size(index, &error) == 2, error);

    /* save / load / view / metadata */
    char const* path = argv[1];
    usearch_save(index, path, &error);
    CHECK(error == NULL, error);

    usearch_init_options_t sniffed;
    memset(&sniffed, 0, sizeof(sniffed));
    usearch_metadata(path, &sniffed, &error);
    CHECK(error == NULL, error);
    CHECK(sniffed.dimensions == 4, "metadata dims mismatch");
    CHECK(sniffed.metric_kind == usearch_metric_l2sq_k, "metadata metric mismatch");

    usearch_index_t loaded = usearch_init(&opts, &error);
    usearch_load(loaded, path, &error);
    CHECK(error == NULL, error);
    CHECK(usearch_size(loaded, &error) == 2, error);
    found = usearch_search(loaded, v1, usearch_scalar_f32_k, 2, keys, dists, &error);
    CHECK(found == 2 && keys[0] == 42, "loaded search mismatch");

    usearch_index_t viewed = usearch_init(&opts, &error);
    usearch_view(viewed, path, &error);
    CHECK(error == NULL, error);
    CHECK(usearch_size(viewed, &error) == 2, error);

    /* distance + exact search helpers */
    usearch_distance_t d =
        usearch_distance(v1, v2, usearch_scalar_f32_k, 4, usearch_metric_l2sq_k, &error);
    CHECK(fabsf(d - 0.20f) < 1e-4f, "distance mismatch");

    float dataset[8] = {0, 0, 0, 0, 1, 1, 1, 1};
    usearch_key_t ekeys[1];
    usearch_distance_t edists[1];
    usearch_exact_search(dataset, 2, 0, v3, 1, 0, usearch_scalar_f32_k, 4,
                         usearch_metric_l2sq_k, 1, 0, ekeys, 0, edists, 0, &error);
    CHECK(error == NULL, error);
    CHECK(ekeys[0] == 1, "exact search mismatch");

    /* buffer save / load / view / metadata round trip */
    {
        size_t need = usearch_serialized_length(index, &error);
        CHECK(need > 0 && error == NULL, error);
        void* buf = malloc(need);
        usearch_save_buffer(index, buf, need, &error);
        CHECK(error == NULL, error);

        memset(&sniffed, 0, sizeof(sniffed));
        usearch_metadata_buffer(buf, need, &sniffed, &error);
        CHECK(error == NULL && sniffed.dimensions == 4, "metadata_buffer mismatch");

        usearch_index_t from_buf = usearch_init(&opts, &error);
        usearch_load_buffer(from_buf, buf, need, &error);
        CHECK(error == NULL, error);
        CHECK(usearch_size(from_buf, &error) == 2, error);

        usearch_index_t view_buf = usearch_init(&opts, &error);
        usearch_view_buffer(view_buf, buf, need, &error);
        CHECK(error == NULL, error);
        CHECK(usearch_size(view_buf, &error) == 2, error);
        usearch_free(from_buf, &error);
        usearch_free(view_buf, &error);
        free(buf);
    }

    /* custom C metric: host-evaluated per pair (reference UDF cost model) */
    {
        usearch_index_t custom = usearch_init(&opts, &error);
        usearch_add(custom, 42, v1, usearch_scalar_f32_k, &error);
        usearch_add(custom, 43, v2, usearch_scalar_f32_k, &error);
        usearch_add(custom, 44, v3, usearch_scalar_f32_k, &error);
        usearch_change_metric(custom, l1_metric, NULL, usearch_metric_unknown_k, &error);
        CHECK(error == NULL, error);
        found = usearch_search(custom, v1, usearch_scalar_f32_k, 3, keys, dists, &error);
        CHECK(error == NULL && found == 3, error);
        CHECK(keys[0] == 42 && dists[0] < 1e-6f, "custom metric self match");
        CHECK(fabsf(dists[1] - 0.8f) < 1e-5f, "custom metric L1 value");
        usearch_free(custom, &error);
    }

    /* custom metric + multi: rows stay slot-aligned with repeated keys */
    {
        usearch_init_options_t mopts = opts;
        mopts.multi = true;
        usearch_index_t mm = usearch_init(&mopts, &error);
        usearch_add(mm, 7, v1, usearch_scalar_f32_k, &error);
        usearch_add(mm, 7, v3, usearch_scalar_f32_k, &error);
        usearch_add(mm, 8, v2, usearch_scalar_f32_k, &error);
        usearch_change_metric(mm, l1_metric, NULL, usearch_metric_unknown_k, &error);
        found = usearch_search(mm, v3, usearch_scalar_f32_k, 3, keys, dists, &error);
        CHECK(error == NULL && found == 3, error);
        CHECK(keys[0] == 7 && dists[0] < 1e-6f, "multi custom metric self match");
        usearch_free(mm, &error);
    }

    /* thread hints are accepted */
    usearch_change_threads_add(index, 8, &error);
    usearch_change_threads_search(index, 8, &error);
    CHECK(error == NULL, error);

    /* metric swap on a live index */
    usearch_change_metric_kind(index, usearch_metric_cos_k, &error);
    CHECK(error == NULL, error);
    found = usearch_search(index, v1, usearch_scalar_f32_k, 2, keys, dists, &error);
    CHECK(error == NULL && found == 2 && keys[0] == 42, "cos search after swap");
    usearch_change_metric_kind(index, usearch_metric_l2sq_k, &error);

    /* error propagation: duplicate key without multi */
    usearch_add(index, 42, v1, usearch_scalar_f32_k, &error);
    CHECK(error != NULL, "duplicate add must error");
    error = NULL;

    usearch_clear(index, &error);
    CHECK(usearch_size(index, &error) == 0, error);

    usearch_free(index, &error);
    usearch_free(loaded, &error);
    usearch_free(viewed, &error);
    printf("C ABI test passed (version %s, %s)\n", usearch_version(), hw);
    return 0;
}
