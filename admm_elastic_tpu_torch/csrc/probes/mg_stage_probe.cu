// Where an iteration of the multigrid solve (mg_vcycle.cuh) spends its
// time, stage by stage: the solve kernel itself, instantiated with its
// PROBE flag, under which thread 0 of CTA 0 writes %globaltimer (ns)
// after each of the solve's stage ends into `stamps`, with the fine
// stages fused (fuse = 1) or not (0), whatever the plan would pick. A microbenchmark, not part of the kernel
// library: utils/time_solves.py --probe builds it into a library of its
// own and reads the stamps.
//
// stamps: mg_probe_slots(n_iters) values; slot 0 before the start's
// barrier, slot 1 after it, then mg_probe_slots_per_pass() slots a pass,
// pass 0 the start's V-cycle (k = -1) and pass k + 1 iteration k, a pass's
// stage ends from its first slot on (the start's pass has no P stage, nor
// unfused the x, r one: it leaves their slots as the caller wrote them).
// mg_probe_stage_names(fuse): the stages a pass ends, '|'-separated, in
// slot order.

#include "../cg_dia.cu"
#include "../cg_ell.cu"

extern "C" {

const char* mg_probe_stage_names(int fuse) {
  return fuse ? admm::mg::FUSED_STAGES : admm::mg::UNFUSED_STAGES;
}

int mg_probe_slots_per_pass() { return admm::mg::STAGE_SLOTS; }

int mg_probe_slots(int n_iters) {
  return 2 + admm::mg::STAGE_SLOTS * (n_iters + 1);
}

// mg_dia_solve_f32 (cg_dia.cu) with stamps
int mg_stage_probe_dia_f32(const float* b, const float* x0, const float* dia,
                           const int* offsets, int D, int n, int n_iters,
                           const void* mg, float* x, float* scratch,
                           int fuse, unsigned long long* stamps,
                           void* stream) {
  return admm::cg::mg_solve<float, true>(b, x0, dia, offsets, D, n, n_iters,
                                         mg, x, scratch, stream, stamps,
                                         fuse);
}

// uamg_ell_solve_f32 (cg_ell.cu) with stamps
int mg_stage_probe_ell_f32(const float* b, const float* x0, const int* idx_t,
                           const float* vals_t, int K, int n, int n_iters,
                           const void* uamg, float* x, float* scratch,
                           int fuse, unsigned long long* stamps,
                           void* stream) {
  return admm::cg::uamg_solve<float, true>(b, x0, idx_t, vals_t, K, n,
                                           n_iters, uamg, x, scratch, stream,
                                           stamps, fuse);
}

}  // extern "C"
