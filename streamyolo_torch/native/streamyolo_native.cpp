// Host-side hot loops of the PyTorch port, a copy of the JAX package's
// native/streamyolo_native.cpp kept with the port so that it builds nothing
// from outside its own package:
//   * cocoeval_match_image / cocoeval_run: the per-image T x D x G greedy
//     matching loop of COCOeval, and the whole evaluate + accumulate pass
//     (the reference accelerates it with its C++ COCOeval_opt).
//   * iou_assoc_greedy: the greedy score-ordered IoU association the
//     reference compiles with Cython (sAP/track/iou_assoc_cp.pyx).
//   * bbox_iou_ltwh: pairwise IoU of ltwh boxes.
//
// Plain C ABI, bound from Python via ctypes in
// streamyolo_torch/native/__init__.py. Build: g++ -O3 -shared -fPIC.

#include <cstdint>
#include <vector>
#include <algorithm>
#include <cmath>

extern "C" {

// Greedy COCO matching for one (image, category, area-range) cell.
//
// Inputs:
//   ious     [D x G] row-major IoU(dt, gt); dts sorted by descending score,
//            gts sorted ignored-last (the caller prepares both orders).
//   gt_ig    [G]     gt ignore flags (0/1) in the sorted order.
//   iscrowd  [G]     crowd flags in the sorted order.
//   iou_thrs [T]     ascending IoU thresholds.
//   dt_ids   [D], gt_ids [G] annotation ids.
// Outputs (pre-allocated by caller):
//   dtm   [T x D] matched gt id per dt (0 = unmatched)
//   gtm   [T x G] matched dt id per gt (0 = unmatched)
//   dt_ig [T x D] dt ignore flags
void cocoeval_match_image(
    const double* ious, int64_t D, int64_t G,
    const uint8_t* gt_ig, const uint8_t* iscrowd,
    const double* iou_thrs, int64_t T,
    const int64_t* dt_ids, const int64_t* gt_ids,
    int64_t* dtm, int64_t* gtm, uint8_t* dt_ig) {
  std::fill(dtm, dtm + T * D, int64_t(0));
  std::fill(gtm, gtm + T * G, int64_t(0));
  std::fill(dt_ig, dt_ig + T * D, uint8_t(0));
  if (D == 0 || G == 0) return;

  for (int64_t t = 0; t < T; ++t) {
    int64_t* dtm_t = dtm + t * D;
    int64_t* gtm_t = gtm + t * G;
    uint8_t* dtig_t = dt_ig + t * D;
    const double thr = std::min(iou_thrs[t], 1.0 - 1e-10);
    for (int64_t d = 0; d < D; ++d) {
      double best = thr;
      int64_t m = -1;
      const double* iou_d = ious + d * G;
      for (int64_t g = 0; g < G; ++g) {
        // gt already matched (and not crowd): skip
        if (gtm_t[g] > 0 && !iscrowd[g]) continue;
        // dt already matched a real gt; remaining gts are ignored: stop
        if (m > -1 && gt_ig[m] == 0 && gt_ig[g] == 1) break;
        if (iou_d[g] < best) continue;
        best = iou_d[g];
        m = g;
      }
      if (m == -1) continue;
      dtig_t[d] = gt_ig[m];
      dtm_t[d] = gt_ids[m];
      gtm_t[m] = dt_ids[d];
    }
  }
}

// Greedy score-ordered IoU association (labels must match; each prev box
// matched at most once). Outputs: matched1/matched2 pairs and unmatched2;
// returns counts via n_matched / n_unmatched2.
void iou_assoc_greedy(
    const double* ious, int64_t m, int64_t n,
    const int64_t* labels1, const int64_t* labels2,
    double match_iou_th,
    int64_t* matched1, int64_t* matched2, int64_t* unmatched2,
    int64_t* n_matched, int64_t* n_unmatched2) {
  std::vector<char> used(m, 0);
  int64_t nm = 0, nu = 0;
  for (int64_t j = 0; j < n; ++j) {
    double best = match_iou_th;
    int64_t match_i = -1;
    for (int64_t i = 0; i < m; ++i) {
      if (used[i] || labels1[i] != labels2[j]) continue;
      const double iou = ious[i * n + j];
      if (iou < best) continue;
      best = iou;
      match_i = i;
    }
    if (match_i < 0) {
      unmatched2[nu++] = j;
    } else {
      matched1[nm] = match_i;
      matched2[nm] = j;
      ++nm;
      used[match_i] = 1;
    }
  }
  *n_matched = nm;
  *n_unmatched2 = nu;
}

// Pairwise IoU of ltwh boxes (crowd => intersection-over-dt-area), the
// box-mode maskUtils.iou capability (used by track association).
void bbox_iou_ltwh(
    const double* dt, int64_t n_dt,
    const double* gt, int64_t n_gt,
    const uint8_t* iscrowd,
    double* out) {
  for (int64_t i = 0; i < n_dt; ++i) {
    const double dx1 = dt[i * 4], dy1 = dt[i * 4 + 1];
    const double dw = dt[i * 4 + 2], dh = dt[i * 4 + 3];
    const double dx2 = dx1 + dw, dy2 = dy1 + dh;
    const double d_area = dw * dh;
    for (int64_t j = 0; j < n_gt; ++j) {
      const double gx1 = gt[j * 4], gy1 = gt[j * 4 + 1];
      const double gw = gt[j * 4 + 2], gh = gt[j * 4 + 3];
      const double gx2 = gx1 + gw, gy2 = gy1 + gh;
      const double iw = std::max(0.0, std::min(dx2, gx2) - std::max(dx1, gx1));
      const double ih = std::max(0.0, std::min(dy2, gy2) - std::max(dy1, gy1));
      const double inter = iw * ih;
      const double uni = iscrowd[j] ? d_area : d_area + gw * gh - inter;
      out[i * n_gt + j] = uni > 0 ? inter / uni : 0.0;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full COCO evaluation core: per-cell greedy matching for every area range
// plus the accumulate pass (global score sort, PR curves), in one call —
// the actual shape of the reference's C++ COCOeval_opt. The NumPy COCOeval
// remains the oracle.
//
// Cells are (category k, image i) pairs, k-major: cell = k * I + i.
// dts within a cell arrive pre-sorted by descending score (stable);
// per-cell counts come via offset arrays (CSR style).
//
// Outputs:
//   precision [T, R, K, A, M] (row-major), recall [T, K, A, M],
//   scores [T, R, K, A, M]; untouched entries must be pre-filled with -1.
extern "C" void cocoeval_run(
    int64_t K, int64_t I,
    const int64_t* dt_off,   // [K*I + 1]
    const int64_t* gt_off,   // [K*I + 1]
    const double* dt_scores, // [sum D] sorted desc per cell
    const double* dt_boxes,  // [sum D, 4] ltwh
    const double* dt_areas,  // [sum D]
    const double* gt_boxes,  // [sum G, 4] ltwh
    const double* gt_areas,  // [sum G]
    const uint8_t* gt_crowd, // [sum G]
    const uint8_t* gt_ign0,  // [sum G] base ignore flag
    const double* iou_thrs, int64_t T,
    const double* rec_thrs, int64_t R,
    const double* area_rng,  // [A*2]
    int64_t A,
    const int64_t* max_dets, int64_t M,
    double* precision,       // [T*R*K*A*M]
    double* recall,          // [T*K*A*M]
    double* out_scores       // [T*R*K*A*M]
) {
  const int64_t max_det_cap = max_dets[M - 1];

  struct DtRec {
    double score;
    int64_t rank;    // rank within its image (post score sort)
    int64_t order;   // global insertion order (image-major) for stable ties
    // per-threshold flags, bit t of each mask
    uint32_t matched;
    uint32_t ignored;
  };

  std::vector<int64_t> gt_order;
  std::vector<uint8_t> gt_ig;
  std::vector<int64_t> gtm;
  std::vector<DtRec> pool;
  std::vector<double> cell_iou;

  for (int64_t k = 0; k < K; ++k) {
    for (int64_t a = 0; a < A; ++a) {
      const double lo = area_rng[a * 2], hi = area_rng[a * 2 + 1];
      pool.clear();
      int64_t npig = 0;
      int64_t order_counter = 0;

      for (int64_t i = 0; i < I; ++i) {
        const int64_t cell = k * I + i;
        const int64_t d0 = dt_off[cell], d1 = dt_off[cell + 1];
        const int64_t g0 = gt_off[cell], g1 = gt_off[cell + 1];
        const int64_t D_all = d1 - d0;
        const int64_t G = g1 - g0;
        if (D_all == 0 && G == 0) continue;
        const int64_t D = std::min(D_all, max_det_cap);

        // gt ignore flags for this area + stable sort ignored-last
        gt_ig.resize(G);
        gt_order.resize(G);
        for (int64_t g = 0; g < G; ++g) {
          const double ga = gt_areas[g0 + g];
          gt_ig[g] = (gt_ign0[g0 + g] || ga < lo || ga > hi) ? 1 : 0;
          gt_order[g] = g;
        }
        std::stable_sort(gt_order.begin(), gt_order.end(),
                         [&](int64_t x, int64_t y) { return gt_ig[x] < gt_ig[y]; });

        for (int64_t g = 0; g < G; ++g)
          if (gt_ig[g] == 0) ++npig;

        // per-cell IoU (dt ltwh vs gt ltwh; crowd => over-dt-area)
        cell_iou.resize(D * G);
        bbox_iou_ltwh(dt_boxes + d0 * 4, D, gt_boxes + g0 * 4, G,
                      gt_crowd + g0, cell_iou.data());
        const double* cell_ious = cell_iou.data();

        // matching
        gtm.assign(T * G, -1);
        const int64_t base = pool.size();
        for (int64_t d = 0; d < D; ++d) {
          DtRec rec;
          rec.score = dt_scores[d0 + d];
          rec.rank = d;
          rec.order = order_counter++;
          rec.matched = 0;
          rec.ignored = 0;
          pool.push_back(rec);
        }
        for (int64_t t = 0; t < T; ++t) {
          const double thr = std::min(iou_thrs[t], 1.0 - 1e-10);
          for (int64_t d = 0; d < D; ++d) {
            double best = thr;
            int64_t m = -1;  // position in sorted gt order
            for (int64_t gpos = 0; gpos < G; ++gpos) {
              const int64_t g = gt_order[gpos];
              if (gtm[t * G + gpos] >= 0 && !gt_crowd[g0 + g]) continue;
              if (m > -1 && gt_ig[gt_order[m]] == 0 && gt_ig[g] == 1) break;
              const double iou = cell_ious[d * G + g];
              if (iou < best) continue;
              best = iou;
              m = gpos;
            }
            DtRec& rec = pool[base + d];
            if (m == -1) {
              // unmatched: ignored if the dt's area is outside the range
              const double da = dt_areas[d0 + d];
              if (da < lo || da > hi) rec.ignored |= (1u << t);
              continue;
            }
            gtm[t * G + m] = d;
            rec.matched |= (1u << t);
            if (gt_ig[gt_order[m]]) rec.ignored |= (1u << t);
          }
        }
      }

      if (npig == 0) continue;

      // global stable sort by descending score (ties keep image order)
      std::stable_sort(pool.begin(), pool.end(), [](const DtRec& x, const DtRec& y) {
        return x.score > y.score;
      });

      for (int64_t m = 0; m < M; ++m) {
        const int64_t cap = max_dets[m];
        // walk the sorted pool, skipping dts beyond this maxDet
        for (int64_t t = 0; t < T; ++t) {
          double tp = 0, fp = 0;
          double last_rc = 0;
          // precision envelope needs all points first
          static thread_local std::vector<double> rc_v, pr_v, sc_v;
          rc_v.clear(); pr_v.clear(); sc_v.clear();
          for (const DtRec& rec : pool) {
            if (rec.rank >= cap) continue;
            const bool ig = rec.ignored & (1u << t);
            const bool mt = rec.matched & (1u << t);
            if (mt && !ig) tp += 1;
            else if (!mt && !ig) fp += 1;
            else continue;  // ignored dts contribute no point
            rc_v.push_back(tp / npig);
            pr_v.push_back(tp / (tp + fp + 1e-300));
            sc_v.push_back(rec.score);
          }
          const int64_t nd = rc_v.size();
          last_rc = nd ? rc_v.back() : 0;
          recall[((t * K + k) * A + a) * M + m] = last_rc;
          // monotone envelope
          for (int64_t p = nd - 1; p > 0; --p)
            if (pr_v[p] > pr_v[p - 1]) pr_v[p - 1] = pr_v[p];
          // sample at recall thresholds (searchsorted left)
          int64_t pi = 0;
          for (int64_t r = 0; r < R; ++r) {
            // first index with rc >= rec_thrs[r]
            while (pi < nd && rc_v[pi] < rec_thrs[r]) ++pi;
            const int64_t out =
                (((t * R + r) * K + k) * A + a) * M + m;
            if (pi < nd) {
              precision[out] = pr_v[pi];
              out_scores[out] = sc_v[pi];
            } else {
              precision[out] = 0.0;
              out_scores[out] = 0.0;
            }
          }
        }
      }
    }
  }
}
