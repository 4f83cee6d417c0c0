// Native token-packing buffer for the data-loader hot path.
//
// The Python pipeline accumulates per-example token/mask lists and slices
// them into (batch, seq) training chunks; at million-token batches the
// Python list splicing dominates loader CPU time. This ring-buffer keeps
// tokens/masks in contiguous C arrays: O(1) amortized append, memcpy emit.
//
// Exposed via ctypes (see token_buffer.py). Plain C ABI, no Python API.
// The same source as lwm_tpu/native/token_buffer.cpp; the PyTorch port
// keeps its own copy and builds it into lwm_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

struct TokenBuffer {
    std::vector<int32_t> tokens;
    std::vector<float> masks;
    std::vector<uint8_t> vision;
    size_t head = 0;  // consumed prefix

    size_t size() const { return tokens.size() - head; }

    void compact() {
        // reclaim consumed prefix when it dominates the buffer
        if (head > 0 && head * 2 > tokens.size()) {
            tokens.erase(tokens.begin(), tokens.begin() + head);
            masks.erase(masks.begin(), masks.begin() + head);
            vision.erase(vision.begin(), vision.begin() + head);
            head = 0;
        }
    }
};

TokenBuffer* tb_create() { return new TokenBuffer(); }

void tb_destroy(TokenBuffer* tb) { delete tb; }

void tb_append(TokenBuffer* tb, const int32_t* tokens, const float* masks,
               const uint8_t* vision, int64_t n) {
    tb->tokens.insert(tb->tokens.end(), tokens, tokens + n);
    tb->masks.insert(tb->masks.end(), masks, masks + n);
    if (vision != nullptr) {
        tb->vision.insert(tb->vision.end(), vision, vision + n);
    } else {
        tb->vision.insert(tb->vision.end(), (size_t)n, (uint8_t)0);
    }
}

int64_t tb_size(const TokenBuffer* tb) { return (int64_t)tb->size(); }

// Emit one packed batch if ≥ chunk+1 tokens are buffered (the +1 provides
// the shifted next-token targets). Writes:
//   input_tokens  [chunk]   = tokens[0 : chunk]
//   target_tokens [chunk]   = tokens[1 : chunk+1]
//   loss_masks    [chunk]   = masks [1 : chunk+1]
//   input_vision  [chunk]   = vision[0 : chunk]
//   target_vision [chunk]   = vision[1 : chunk+1]
// and consumes `chunk` tokens. Returns 1 on emit, 0 if underfull.
int32_t tb_emit(TokenBuffer* tb, int64_t chunk,
                int32_t* input_tokens, int32_t* target_tokens,
                float* loss_masks, uint8_t* input_vision,
                uint8_t* target_vision) {
    if ((int64_t)tb->size() < chunk + 1) return 0;
    const int32_t* t = tb->tokens.data() + tb->head;
    const float* m = tb->masks.data() + tb->head;
    const uint8_t* v = tb->vision.data() + tb->head;
    std::memcpy(input_tokens, t, sizeof(int32_t) * chunk);
    std::memcpy(target_tokens, t + 1, sizeof(int32_t) * chunk);
    std::memcpy(loss_masks, m + 1, sizeof(float) * chunk);
    if (input_vision) std::memcpy(input_vision, v, sizeof(uint8_t) * chunk);
    if (target_vision) std::memcpy(target_vision, v + 1, sizeof(uint8_t) * chunk);
    tb->head += chunk;
    tb->compact();
    return 1;
}

void tb_clear(TokenBuffer* tb) {
    tb->tokens.clear();
    tb->masks.clear();
    tb->vision.clear();
    tb->head = 0;
}

}  // extern "C"
