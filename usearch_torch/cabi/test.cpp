/* C++ wrapper smoke test of usearch_torch: RAII round trips over the C ABI,
 * the calls of the JAX package's cpp/test.cpp, modeled on the reference's
 * cpp/test.cpp flows (test_minimal_three_vectors:206,
 * test_punned_add_remove_vector:384, filtered search:1105, exact:879).
 *
 *     test_cpp <index file path>
 *
 * Runs on the card unless USEARCH_TORCH_DEVICE=cpu. Exits 0 on success. */

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "usearch_torch.hpp"

#define CHECK(expr)                                                            \
    do {                                                                       \
        if (!(expr)) {                                                         \
            std::fprintf(stderr, "FAILED: %s at %s:%d\n", #expr, __FILE__,     \
                         __LINE__);                                            \
            std::exit(1);                                                      \
        }                                                                      \
    } while (0)

using namespace usearch_torch;

static void expect_throws(index_t& index) {
    bool threw = false;
    try {
        index.load("/nonexistent/usearch_torch_missing.usearch");
    } catch (index_error const&) {
        threw = true;
    }
    CHECK(threw);
}

int main(int argc, char** argv) {
    if (argc != 2) {
        std::fprintf(stderr, "usage: %s <index file path>\n", argv[0]);
        return 2;
    }
    CHECK(!version().empty());

    index_config_t config;
    config.metric = metric_kind_t::l2sq_k;
    config.quantization = scalar_kind_t::f32_k;
    config.dimensions = 4;
    index_t index(config);
    CHECK(static_cast<bool>(index));
    CHECK(index.size() == 0);
    CHECK(index.dimensions() == 4);
    CHECK(index.connectivity() > 0);

    float v1[4] = {0.1f, 0.2f, 0.3f, 0.4f};
    float v2[4] = {0.4f, 0.3f, 0.2f, 0.1f};
    float v3[4] = {0.9f, 0.9f, 0.9f, 0.9f};
    index.add(42, v1);
    index.add(43, v2);
    index.add(44, v3);
    CHECK(index.size() == 3);
    CHECK(index.contains(42));
    CHECK(!index.contains(999));
    CHECK(index.count(43) == 1);

    // search: self nearest, exact distances
    std::vector<match_t> matches = index.search(v1, 3);
    CHECK(matches.size() == 3);
    CHECK(matches[0].key == 42);
    CHECK(matches[0].distance < 1e-6f);
    CHECK(matches[1].distance <= matches[2].distance);

    // filtered search restricts candidates
    std::vector<vector_key_t> allowed = {43, 44};
    matches = index.filtered_search(v1, scalar_kind_t::f32_k, 3, allowed);
    CHECK(matches.size() == 2);
    CHECK(matches[0].key == 43);

    // get round trip
    float out[4] = {0};
    CHECK(index.get(42, out, 1, scalar_kind_t::f32_k) == 1);
    for (int i = 0; i != 4; ++i)
        CHECK(std::fabs(out[i] - v1[i]) < 1e-6f);

    // remove + rename
    CHECK(index.remove(44) == 1);
    CHECK(index.size() == 2);
    CHECK(index.rename(43, 99) == 1);
    CHECK(index.contains(99) && !index.contains(43));

    // persistence: save / load / view / metadata
    std::string path = argv[1];
    index.save(path);
    index_t loaded(config);
    loaded.load(path);
    CHECK(loaded.size() == 2);
    CHECK(loaded.search(v1, 1)[0].key == 42);
    index_t viewed(config);
    viewed.view(path);
    CHECK(viewed.size() == 2);
    index_config_t meta = index_t::metadata(path);
    CHECK(meta.dimensions == 4);
    CHECK(meta.metric == metric_kind_t::l2sq_k);

    // move semantics: handle transfers, source empties
    index_t moved(std::move(loaded));
    CHECK(static_cast<bool>(moved) && !static_cast<bool>(loaded));
    CHECK(moved.size() == 2);

    // errors surface as exceptions
    expect_throws(moved);

    // free function: pairwise distance
    distance_t d = distance(v1, v2, scalar_kind_t::f32_k, 4, metric_kind_t::l2sq_k);
    CHECK(std::fabs(d - 0.2f) < 1e-3f);

    // exact brute-force over a raw dataset
    float dataset[8] = {0.f, 0.f, 0.f, 1.f, 1.f, 0.f, 0.f, 0.f};
    vector_key_t keys[2];
    distance_t dists[2];
    exact_search(dataset, 2, v3, 1, scalar_kind_t::f32_k, 4,
                 metric_kind_t::l2sq_k, 2, keys, dists);
    CHECK(dists[0] <= dists[1]);

    // clear empties the index
    moved.clear();
    CHECK(moved.size() == 0);

    std::printf("C++ wrapper test passed\n");
    return 0;
}
