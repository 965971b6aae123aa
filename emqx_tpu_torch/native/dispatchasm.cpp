// GIL-released PUBLISH assembly for the dispatch fan-out.
//
// The window encoder (emqx_tpu_torch.codec.mqtt.DispatchEncoder)
// serializes each unique PUBLISH body once per window into a
// contiguous arena and records, per body, the head span (fixed header
// .. topic) and tail span (properties + payload) around the 2-byte
// packet-id slot.  The per-delivery Python path splices those per
// subscriber (one bytes join + one Packet object per delivery); these
// functions splice a whole client run, or a whole window of runs, in
// one ctypes call: head splice, big-endian pid patch, tail splice,
// straight into one caller-sized output buffer whose per-run slices
// become the connections' corked writes.  ctypes releases the GIL for
// the duration.

#include <cstdint>
#include <cstring>

extern "C" {

// Assemble one client's delivery run into `out` (caller-allocated to
// the exact total size).  Per delivery i: body[i] indexes the arena
// span tables; pid[i] >= 0 means a QoS>0 frame whose 2-byte packet id
// is spliced between head and tail, pid[i] < 0 a QoS 0 frame whose
// head span IS the whole frame (tail_len 0).  Returns bytes written
// (the caller asserts it equals the precomputed total).
int64_t da_assemble_run(const uint8_t* arena,
                        const int64_t* head_off, const int64_t* head_len,
                        const int64_t* tail_off, const int64_t* tail_len,
                        const int64_t* body, const int64_t* pid,
                        int64_t n, uint8_t* out) {
    uint8_t* w = out;
    for (int64_t i = 0; i < n; i++) {
        const int64_t b = body[i];
        const int64_t hl = head_len[b];
        std::memcpy(w, arena + head_off[b], (size_t)hl);
        w += hl;
        const int64_t p = pid[i];
        if (p >= 0) {
            *w++ = (uint8_t)((p >> 8) & 0xFF);
            *w++ = (uint8_t)(p & 0xFF);
        }
        const int64_t tl = tail_len[b];
        if (tl) {
            std::memcpy(w, arena + tail_off[b], (size_t)tl);
            w += tl;
        }
    }
    return (int64_t)(w - out);
}

// Assemble an entire dispatch window — EVERY client's run — in one
// GIL-released call.  The caller concatenates the per-run (body, pid)
// columns into window-wide arrays and precomputes each run's byte
// offset into the shared output buffer (the "splice plan"): run j
// covers deliveries [run_start[j], run_start[j+1]) and its bytes must
// land exactly at out + run_out_off[j], so each client's slice of the
// window buffer becomes that connection's corked write with zero
// re-copy.  The per-run offset is re-checked at every run boundary:
// one corrupt span table mis-sizing run j returns -(j+1) immediately
// instead of silently shifting every later client's wire bytes.
int64_t da_assemble_window(const uint8_t* arena,
                           const int64_t* head_off, const int64_t* head_len,
                           const int64_t* tail_off, const int64_t* tail_len,
                           const int64_t* body, const int64_t* pid,
                           const int64_t* run_start,
                           const int64_t* run_out_off,
                           int64_t n_runs, int64_t n_total, uint8_t* out) {
    uint8_t* w = out;
    for (int64_t j = 0; j < n_runs; j++) {
        if (w != out + run_out_off[j]) return -(j + 1);
        const int64_t end = (j + 1 < n_runs) ? run_start[j + 1] : n_total;
        for (int64_t i = run_start[j]; i < end; i++) {
            const int64_t b = body[i];
            const int64_t hl = head_len[b];
            std::memcpy(w, arena + head_off[b], (size_t)hl);
            w += hl;
            const int64_t p = pid[i];
            if (p >= 0) {
                *w++ = (uint8_t)((p >> 8) & 0xFF);
                *w++ = (uint8_t)(p & 0xFF);
            }
            const int64_t tl = tail_len[b];
            if (tl) {
                std::memcpy(w, arena + tail_off[b], (size_t)tl);
                w += tl;
            }
        }
    }
    return (int64_t)(w - out);
}

}  // extern "C"
