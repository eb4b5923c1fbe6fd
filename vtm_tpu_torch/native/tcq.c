/* Batched TCQ scan — native twin of vtm_tpu_torch/encoder/tcq_scan.py.
 *
 * Mechanical C rendering of the vectorized-scan design in tcq_scan.py
 * (decide / advance phases over a struct-of-arrays state bank, extended
 * predecessor gathers, double-buffered per-state history planes), kept
 * bit-identical to it for the low-latency host path: the Python module
 * is the design reference and test oracle, this file is the fast
 * sequential/small-batch engine.  Rate tables are computed in Python
 * (dq_ctx) and passed in per TU; geometry tables are shared per shape.
 *
 * Behavioral contract (not code): the reference dependent quantizer,
 * DepQuant.cpp:806-1008.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define NS 4
#define SBBMAX 16
#define SC_BITS 15
#define RICEMAX 32
#define RD_MAX  ((int64_t)(((uint64_t)1 << 62) - 1))
#define RD_MAX4 ((int64_t)(((uint64_t)1 << 61) - 1))

static const uint8_t RICE_PARS[32] = {
    0,0,0,0,0,0,0,1,1,1,1,1,1,1,2,2,2,2,2,2,2,2,2,2,2,2,2,2,3,3,3,3 };

static int64_t RICE_BITS[4][RICEMAX];
static int rice_ready = 0;

static void rice_init(void) {
    for (int p = 0; p < 4; p++)
        for (int prefix = 0; prefix < 64; prefix++) {
            int64_t base, size, bits;
            if (prefix < 5) {
                base = (int64_t)prefix << p; size = 1ll << p;
                bits = prefix + 1 + p;
            } else {
                base = ((1ll << (prefix - 5)) + 4) << p;
                size = 1ll << (p + prefix - 5);
                bits = prefix + 1 + p + (prefix - 5);
            }
            if (base >= RICEMAX) break;
            for (int64_t v = base; v < base + size && v < RICEMAX; v++)
                RICE_BITS[p][v] = bits << SC_BITS;
        }
    rice_ready = 1;
}

/* ---- shared run context (one TU batch) ---- */
typedef struct {
    int n, sbb_l2, sbb, nsbb, wig, ch_luma, init_rem, first_cap;
    int q_shift, dist_shift;
    int64_t q_add, max_q_idx, q_scale, dist_step_add, dist_org_fact,
        dist_add;
    const int32_t *sbbpos, *sx, *sy, *nbs, *nbo;
    const int8_t *nbs_num, *nbo_num;
    const uint8_t *zero;
    /* derived per-position metadata */
    int *sig_off, *gtx_off, *inside, *eosbb, *soc, *eoc;
    int *sbb_raster, *sbb_right, *sbb_below;
} Ctx;

/* per-state bank: plane arrays indexed [slot] */
typedef struct {
    int64_t cost[NS];
    int32_t nsig[NS], rem[NS], ref[NS], rice_p[NS], rice_z[NS];
    int64_t sig_f[NS][2], cfrac[NS][6], sbb_f[NS][2];
    int32_t lv16[NS][SBBMAX], tmpl[NS][SBBMAX];
} Bank;

typedef struct {
    int64_t cost[NS], sbbf0[NS];
    int32_t ref[NS], rem[NS];
} SkipChain;

typedef struct { int64_t cost; int32_t lv; int32_t pv; } Slot;

static void bank_reinit_slot(Bank *st, int k, const int64_t sig_init[NS][2],
                             const int64_t *cf_init) {
    st->nsig[k] = 0; st->rem[k] = 4; st->ref[k] = -1;
    st->rice_p[k] = 0; st->rice_z[k] = 0;
    st->sig_f[k][0] = sig_init[k][0]; st->sig_f[k][1] = sig_init[k][1];
    memcpy(st->cfrac[k], cf_init, 6 * sizeof(int64_t));
    st->sbb_f[k][0] = st->sbb_f[k][1] = 0;
    memset(st->lv16[k], 0, sizeof(st->lv16[k]));
    memset(st->tmpl[k], 0, sizeof(st->tmpl[k]));
}

static inline int64_t rate_regular(int64_t lv, const int64_t *cfrac,
                                   int rice_p) {
    if (lv < 4) return cfrac[lv];
    int64_t rem = (lv - 4) >> 1;
    int64_t ri = rem < RICEMAX - 1 ? rem : RICEMAX - 1;
    return cfrac[lv - (rem << 1)] + RICE_BITS[rice_p][ri];
}

static inline int64_t rate_bypass(int64_t lv, int rice_p, int rice_z) {
    int64_t idx = lv <= rice_z ? lv - 1
                               : (lv < RICEMAX - 1 ? lv : RICEMAX - 1);
    if (idx < 0) idx = 0;
    return ((int64_t)1 << SC_BITS) + RICE_BITS[rice_p][idx];
}

static inline void slot_min(Slot *s, int64_t c, int32_t lv, int32_t pv) {
    if (c < s->cost) { s->cost = c; s->lv = lv; s->pv = pv; }
}

/* ---- decide phase: ordered candidate stacks per slot ---- */
static void decide(const Ctx *tc, int i, const int64_t *absc,
                   const int64_t *last, const Bank *st,
                   const SkipChain *skip, const int64_t *start_cf,
                   int soc, int eoc, int zo, Slot dec[NS]) {
    for (int k = 0; k < NS; k++) {
        dec[k].cost = RD_MAX4; dec[k].lv = 0; dec[k].pv = -2;
    }
    if (zo) {
        if (eoc)
            for (int k = 0; k < NS; k++) {
                dec[k].cost = skip->cost[k] + skip->sbbf0[k];
                dec[k].lv = 0; dec[k].pv = NS + k;
            }
        return;
    }
    /* pre-quant: 4 neighbor indices keyed by (qIdx & 3) */
    int64_t so = absc[i] * tc->q_scale;
    int64_t qi = (so + tc->q_add) >> tc->q_shift;
    if (qi < 1) qi = 1;
    if (qi > tc->max_q_idx) qi = tc->max_q_idx;
    int64_t pq_dd[4], pq_lv[4];
    int64_t sadd = qi * tc->dist_step_add - so * tc->dist_org_fact;
    for (int t = 0; t < 4; t++) {
        int key = (int)(qi & 3);
        pq_dd[key] = (sadd * qi + tc->dist_add) >> tc->dist_shift;
        pq_lv[key] = (qi + 1) >> 1;
        sadd += tc->dist_step_add;
        qi++;
    }
    static const int A_of[NS] = {0, 0, 3, 3};
    static const int B_of[NS] = {2, 2, 1, 1};
    int64_t cA[NS], cB[NS], cZ[NS], lvA[NS], lvB[NS];
    for (int s = 0; s < NS; s++) {
        lvA[s] = pq_lv[A_of[s]]; lvB[s] = pq_lv[B_of[s]];
        if (st->cost[s] >= RD_MAX) {
            cA[s] = cB[s] = cZ[s] = RD_MAX4;
            continue;
        }
        int reg = st->rem[s] >= 4;
        int64_t rA, rB, rZ, sig1 = 0, sig0 = 0;
        int z_on = 1;
        if (reg) {
            rA = rate_regular(lvA[s], st->cfrac[s], st->rice_p[s]);
            rB = rate_regular(lvB[s], st->cfrac[s], st->rice_p[s]);
            if (soc) {
                sig1 = st->sbb_f[s][1] + st->sig_f[s][1];
                sig0 = st->sbb_f[s][1] + st->sig_f[s][0];
            } else if (eoc) {
                if (st->nsig[s] > 0) {
                    sig1 = st->sig_f[s][1]; sig0 = st->sig_f[s][0];
                } else {
                    z_on = 0;
                }
            } else {
                sig1 = st->sig_f[s][1]; sig0 = st->sig_f[s][0];
            }
            rZ = sig0;
        } else {
            rA = rate_bypass(lvA[s], st->rice_p[s], st->rice_z[s]);
            rB = rate_bypass(lvB[s], st->rice_p[s], st->rice_z[s]);
            rZ = RICE_BITS[st->rice_p[s]][st->rice_z[s]];
        }
        cA[s] = st->cost[s] + pq_dd[A_of[s]] + rA + sig1;
        cB[s] = st->cost[s] + pq_dd[B_of[s]] + rB + sig1;
        cZ[s] = z_on ? st->cost[s] + rZ : RD_MAX4;
    }
    /* wiring (first-wins order):
     *   slot0: s0A s0Z s1B | slot2: s0B s1A s1Z
     *   slot1: s2A s2Z s3B | slot3: s2B s3A s3Z            */
    slot_min(&dec[0], cA[0], (int32_t)lvA[0], 0);
    slot_min(&dec[0], cZ[0], 0, 0);
    slot_min(&dec[0], cB[1], (int32_t)lvB[1], 1);
    slot_min(&dec[2], cB[0], (int32_t)lvB[0], 0);
    slot_min(&dec[2], cA[1], (int32_t)lvA[1], 1);
    slot_min(&dec[2], cZ[1], 0, 1);
    slot_min(&dec[1], cA[2], (int32_t)lvA[2], 2);
    slot_min(&dec[1], cZ[2], 0, 2);
    slot_min(&dec[1], cB[3], (int32_t)lvB[3], 3);
    slot_min(&dec[3], cB[2], (int32_t)lvB[2], 2);
    slot_min(&dec[3], cA[3], (int32_t)lvA[3], 3);
    slot_min(&dec[3], cZ[3], 0, 3);
    if (eoc)
        for (int k = 0; k < NS; k++)
            if (skip->cost[k] < RD_MAX)
                slot_min(&dec[k], skip->cost[k] + skip->sbbf0[k], 0,
                         NS + k);
    for (int j = 0; j < 2; j++) {
        int k = j ? 2 : 0, p = j ? 2 : 0;
        int64_t sc = pq_dd[p] + last[i]
                     + rate_regular(pq_lv[p], start_cf, 0);
        slot_min(&dec[k], sc, (int32_t)pq_lv[p], -1);
    }
}

/* packed template entry from level history: num | abs1<<3 | abs<<8 */
static inline int32_t pack_tmpl(const uint8_t *hist, const int32_t *nb,
                                int num) {
    int32_t s_num = 0, s_ab1 = 0, s_abs = 0;
    for (int q = 0; q < num; q++) {
        int t = hist[nb[q]];
        s_abs += t;
        s_ab1 += t < 4 + (t & 1) ? t : 4 + (t & 1);
        s_num += t != 0;
    }
    if (s_abs > 127) s_abs = 127;
    return s_num + (s_ab1 << 3) + (s_abs << 8);
}

/* ---- one TU ---- */
static void run_one(const Ctx *tc, const int64_t *absc, const int64_t *last,
                    const int32_t *sig, const int32_t *gtx, int32_t *lev,
                    int32_t *dec_lv, int8_t *dec_pv, uint8_t *planes) {
    int n = tc->n, sbb = tc->sbb;
    memset(lev, 0, (size_t)n * sizeof(int32_t));
    int top = tc->first_cap < n ? tc->first_cap - 1 : n - 1;
    for (; top >= 0; top--) {
        if (tc->zero[top]) continue;
        if (absc[top] * tc->q_scale * 4 > ((int64_t)4 << tc->q_shift))
            break;
    }
    if (top < 0) return;

    /* slot-indexed init rows from the rate tables */
    int64_t sig_init[NS][2], cf_init[6];
    for (int k = 0; k < NS; k++) {
        int set = k <= 1 ? 0 : k - 1;
        sig_init[k][0] = sig[(set * 12) * 2];
        sig_init[k][1] = sig[(set * 12) * 2 + 1];
    }
    for (int c = 0; c < 6; c++) cf_init[c] = gtx[c];
    int64_t sbbbits[2][2] = {{sig[36 * 2], sig[36 * 2 + 1]},
                             {sig[37 * 2], sig[37 * 2 + 1]}};

    Bank bank, *st = &bank;
    SkipChain skip;
    for (int k = 0; k < NS; k++) {
        st->cost[k] = RD_MAX;
        bank_reinit_slot(st, k, sig_init, cf_init);
        skip.cost[k] = RD_MAX; skip.sbbf0[k] = 0;
        skip.ref[k] = -1; skip.rem[k] = 4;
    }
    /* history planes: [buf][slot] significance flags + level history */
    size_t fstride = (size_t)tc->nsbb, hstride = (size_t)n;
    uint8_t *flags[2], *hist[2];
    flags[0] = planes; flags[1] = planes + NS * fstride;
    hist[0] = planes + 2 * NS * fstride;
    hist[1] = hist[0] + NS * hstride;
    memset(planes, 0, 2 * NS * (fstride + hstride));

    Slot dec[NS];
    for (int i = top; i >= 0; i--) {
        int inside = tc->inside[i], eosbb = tc->eosbb[i];
        int soc = tc->soc[i], eoc = tc->eoc[i], zo = tc->zero[i];
        decide(tc, i, absc, last, st, &skip, cf_init, soc, eoc, zo, dec);
        for (int k = 0; k < NS; k++) {
            dec_lv[(size_t)i * 2 * NS + k] = dec[k].lv;
            dec_pv[(size_t)i * 2 * NS + k] = (int8_t)dec[k].pv;
            dec_lv[(size_t)i * 2 * NS + NS + k] = 0;
            dec_pv[(size_t)i * 2 * NS + NS + k] = (int8_t)(NS + k);
        }
        if (i == 0) break;

        SkipChain snap;
        if (soc) {
            for (int k = 0; k < NS; k++) {
                snap.cost[k] = st->cost[k];
                snap.sbbf0[k] = st->sbb_f[k][0];
                snap.ref[k] = st->ref[k];
                snap.rem[k] = st->rem[k];
            }
        }
        int nxt = i - 1;
        if (eosbb) {
            /* ---- group-boundary advance ---- */
            uint8_t *t;
            t = flags[0]; flags[0] = flags[1]; flags[1] = t;
            t = hist[0]; hist[0] = hist[1]; hist[1] = t;
            int raster = tc->sbb_raster[i >> tc->sbb_l2];
            int nid = nxt >> tc->sbb_l2;
            int right = tc->sbb_right[nid], below = tc->sbb_below[nid];
            int beg = i - sbb;
            Bank nb;
            for (int k = 0; k < NS; k++) {
                const Slot *d = &dec[k];
                nb.cost[k] = d->cost;
                if (d->pv <= -2) {
                    bank_reinit_slot(&nb, k, sig_init, cf_init);
                    memset(flags[0] + k * fstride, 0, fstride);
                    memset(hist[0] + k * hstride, 0, hstride);
                    continue;
                }
                int from_skip = d->pv >= NS, from_start = d->pv == -1;
                int pi = from_skip ? d->pv - NS : d->pv;
                int32_t pv_ref = from_start ? -1
                                 : from_skip ? skip.ref[pi] : st->ref[pi];
                int32_t pv_rem = from_start ? tc->init_rem
                                 : from_skip ? skip.rem[pi] : st->rem[pi];
                int nsig_t = from_skip ? 0
                             : from_start ? 1
                             : st->nsig[pi] + (d->lv != 0);
                uint8_t abs_full[SBBMAX];
                memset(abs_full, 0, sizeof(abs_full));
                if (!from_skip && !from_start)
                    for (int c = 0; c < sbb; c++)
                        abs_full[c] = (uint8_t)(st->lv16[pi][c] < 255
                                                ? st->lv16[pi][c] : 255);
                abs_full[0] = (uint8_t)(d->lv < 255 ? d->lv : 255);
                uint8_t *fl = flags[0] + k * fstride;
                uint8_t *hi = hist[0] + k * hstride;
                if (pv_ref >= 0) {
                    memcpy(fl, flags[1] + pv_ref * fstride, fstride);
                    memset(hi, 0, (size_t)i);
                    memcpy(hi + i, hist[1] + pv_ref * hstride + i,
                           (size_t)(n - i));
                } else {
                    memset(fl, 0, fstride);
                    memset(hi, 0, hstride);
                }
                fl[raster] = nsig_t != 0;
                memcpy(hi + i, abs_full, (size_t)sbb);
                int sig_nb = ((right && fl[right]) || (below && fl[below]))
                             ? 1 : 0;
                nb.nsig[k] = 0;
                nb.rem[k] = pv_rem;
                nb.rice_p[k] = 0;
                nb.rice_z[k] = k < 2 ? 1 : 2;
                nb.ref[k] = k;
                nb.sbb_f[k][0] = sbbbits[sig_nb][0];
                nb.sbb_f[k][1] = sbbbits[sig_nb][1];
                memset(nb.lv16[k], 0, sizeof(nb.lv16[k]));
                for (int c = 0; c < sbb; c++) {
                    int sp = beg + c, num = tc->nbo_num[sp];
                    nb.tmpl[k][c] = num
                        ? pack_tmpl(hi, tc->nbo + (size_t)sp * 5, num) : 0;
                }
                int ti = nb.tmpl[k][nxt - beg];
                int s_num = ti & 7, s_ab1 = (ti >> 3) & 31;
                int a1 = (s_ab1 + 1) >> 1; if (a1 > 3) a1 = 3;
                int g1 = s_ab1 - s_num; if (g1 > 4) g1 = 4;
                int set = k <= 1 ? 0 : k - 1;
                const int32_t *sg = sig + ((size_t)set * 12
                                           + tc->sig_off[nxt] + a1) * 2;
                nb.sig_f[k][0] = sg[0]; nb.sig_f[k][1] = sg[1];
                const int32_t *gt = gtx + (size_t)(tc->gtx_off[nxt] + g1)
                                    * 6;
                for (int c = 0; c < 6; c++) nb.cfrac[k][c] = gt[c];
            }
            bank = nb;
            for (int k = 0; k < NS; k++) {
                dec_lv[(size_t)i * 2 * NS + NS + k] = dec[k].lv;
                dec_pv[(size_t)i * 2 * NS + NS + k] = (int8_t)dec[k].pv;
            }
        } else if (!zo) {
            /* ---- in-group advance ---- */
            Bank nb;
            int nb_n = tc->nbs_num[nxt];
            const int32_t *nbp = tc->nbs + (size_t)nxt * 5;
            for (int k = 0; k < NS; k++) {
                const Slot *d = &dec[k];
                nb.cost[k] = d->cost;
                if (d->pv <= -2) {
                    bank_reinit_slot(&nb, k, sig_init, cf_init);
                    continue;
                }
                int from_start = d->pv == -1;
                int pi = from_start ? 0 : d->pv;
                int32_t take = d->lv < 2 ? d->lv : 3;
                int32_t rem;
                if (from_start) rem = tc->init_rem - take;
                else {
                    rem = st->rem[pi] - 1;
                    if (rem >= 4) rem -= take;
                }
                nb.nsig[k] = from_start ? 1 : st->nsig[pi] + (d->lv != 0);
                nb.ref[k] = from_start ? -1 : st->ref[pi];
                nb.rem[k] = rem;
                nb.sbb_f[k][0] = from_start ? 0 : st->sbb_f[pi][0];
                nb.sbb_f[k][1] = from_start ? 0 : st->sbb_f[pi][1];
                if (from_start) {
                    memset(nb.lv16[k], 0, sizeof(nb.lv16[k]));
                    memset(nb.tmpl[k], 0, sizeof(nb.tmpl[k]));
                } else {
                    memcpy(nb.lv16[k], st->lv16[pi], sizeof(nb.lv16[k]));
                    memcpy(nb.tmpl[k], st->tmpl[pi], sizeof(nb.tmpl[k]));
                }
                nb.lv16[k][inside] = d->lv < 255 ? d->lv : 255;
                int ti = nb.tmpl[k][nxt & (sbb - 1)];
                int s_num = ti & 7, s_ab1 = (ti >> 3) & 31;
                int s_abs = ti >> 8;
                for (int q = 0; q < nb_n; q++) {
                    int v = nb.lv16[k][nbp[q]];
                    s_ab1 += v < 4 + (v & 1) ? v : 4 + (v & 1);
                    s_num += v != 0;
                    s_abs += v;
                }
                if (rem >= 4) {
                    int a1 = (s_ab1 + 1) >> 1; if (a1 > 3) a1 = 3;
                    int g1 = s_ab1 - s_num; if (g1 > 4) g1 = 4;
                    int set = k <= 1 ? 0 : k - 1;
                    const int32_t *sg = sig + ((size_t)set * 12
                                               + tc->sig_off[nxt] + a1)
                                              * 2;
                    nb.sig_f[k][0] = sg[0]; nb.sig_f[k][1] = sg[1];
                    const int32_t *gt = gtx
                        + (size_t)(tc->gtx_off[nxt] + g1) * 6;
                    for (int c = 0; c < 6; c++) nb.cfrac[k][c] = gt[c];
                    int sa = s_abs - 20;
                    if (sa < 0) sa = 0;
                    if (sa > 31) sa = 31;
                    nb.rice_p[k] = RICE_PARS[sa];
                    nb.rice_z[k] = st->rice_z[k];  /* regime keeps slot value */
                } else {
                    nb.sig_f[k][0] = st->sig_f[pi][0];
                    nb.sig_f[k][1] = st->sig_f[pi][1];
                    memcpy(nb.cfrac[k], st->cfrac[pi],
                           sizeof(nb.cfrac[k]));
                    int sa = s_abs > 31 ? 31 : s_abs;
                    nb.rice_p[k] = RICE_PARS[sa];
                    nb.rice_z[k] = (k < 2 ? 1 : 2) << nb.rice_p[k];
                }
            }
            bank = nb;
        }
        if (soc) skip = snap;
    }
    /* ---- backtrack ---- */
    int64_t best = 0;
    int cur = -1;
    for (int k = 0; k < NS; k++)
        if (dec[k].cost < best) { best = dec[k].cost; cur = k; }
    for (int i = 0; cur >= 0 && i <= top; i++) {
        lev[i] = dec_lv[(size_t)i * 2 * NS + cur];
        cur = dec_pv[(size_t)i * 2 * NS + cur];
    }
}

/* tcq_run(absc(B,n) i64, lev(B,n) i32 out, B, n, first_cap, sbb_l2, wig,
 *   sbbpos i32, sx i32, sy i32, nbs_num i8, nbs i32, nbo_num i8, nbo i32,
 *   zero u8(n), last(B,n) i64, sig(B,38,2) i32, gtx(B,21,6) i32,
 *   ch_luma, init_rem, q_add, max_q_idx, q_scale, dist_step_add,
 *   dist_org_fact, dist_add, q_shift, dist_shift) */
static PyObject *tcq_run(PyObject *self, PyObject *args) {
    PyObject *o_abs, *o_lev, *o_sbbpos, *o_sx, *o_sy, *o_nbsn, *o_nbs,
        *o_nbon, *o_nbo, *o_zero, *o_last, *o_sig, *o_gtx;
    int B, n, first_cap, sbb_l2, wig, ch_luma, init_rem, q_shift,
        dist_shift;
    long long q_add, max_q_idx, q_scale, dist_step_add, dist_org_fact,
        dist_add;
    if (!PyArg_ParseTuple(
            args, "OOiiiiiOOOOOOOOOOOiiLLLLLLii",
            &o_abs, &o_lev, &B, &n, &first_cap, &sbb_l2, &wig,
            &o_sbbpos, &o_sx, &o_sy, &o_nbsn, &o_nbs, &o_nbon, &o_nbo,
            &o_zero, &o_last, &o_sig, &o_gtx, &ch_luma, &init_rem,
            &q_add, &max_q_idx, &q_scale, &dist_step_add, &dist_org_fact,
            &dist_add, &q_shift, &dist_shift))
        return NULL;
    if (!rice_ready) rice_init();
    Py_buffer b[13];
    PyObject *objs[13] = {o_abs, o_lev, o_sbbpos, o_sx, o_sy, o_nbsn,
                          o_nbs, o_nbon, o_nbo, o_zero, o_last, o_sig,
                          o_gtx};
    for (int j = 0; j < 13; j++) {
        int fl = j == 1 ? PyBUF_CONTIG : PyBUF_CONTIG_RO;
        if (PyObject_GetBuffer(objs[j], &b[j], fl) < 0) {
            for (int q = 0; q < j; q++) PyBuffer_Release(&b[q]);
            return NULL;
        }
    }
    Ctx tc;
    tc.n = n; tc.sbb_l2 = sbb_l2; tc.sbb = 1 << sbb_l2;
    tc.nsbb = n >> sbb_l2; tc.wig = wig; tc.ch_luma = ch_luma;
    tc.init_rem = init_rem; tc.first_cap = first_cap;
    tc.q_shift = q_shift; tc.dist_shift = dist_shift;
    tc.q_add = q_add; tc.max_q_idx = max_q_idx; tc.q_scale = q_scale;
    tc.dist_step_add = dist_step_add; tc.dist_org_fact = dist_org_fact;
    tc.dist_add = dist_add;
    tc.sbbpos = (const int32_t *)b[2].buf;
    tc.sx = (const int32_t *)b[3].buf;
    tc.sy = (const int32_t *)b[4].buf;
    tc.nbs_num = (const int8_t *)b[5].buf;
    tc.nbs = (const int32_t *)b[6].buf;
    tc.nbo_num = (const int8_t *)b[7].buf;
    tc.nbo = (const int32_t *)b[8].buf;
    tc.zero = (const uint8_t *)b[9].buf;
    /* per-position metadata */
    int *meta = (int *)malloc((size_t)n * 6 * sizeof(int)
                              + (size_t)tc.nsbb * 3 * sizeof(int));
    int32_t *dec_lv = (int32_t *)malloc((size_t)n * 2 * NS
                                        * sizeof(int32_t));
    int8_t *dec_pv = (int8_t *)malloc((size_t)n * 2 * NS);
    uint8_t *planes = (uint8_t *)malloc(2 * NS
                                        * ((size_t)tc.nsbb + (size_t)n));
    if (!meta || !dec_lv || !dec_pv || !planes) {
        free(meta); free(dec_lv); free(dec_pv); free(planes);
        for (int j = 0; j < 13; j++) PyBuffer_Release(&b[j]);
        return PyErr_NoMemory();
    }
    tc.sig_off = meta; tc.gtx_off = meta + n; tc.inside = meta + 2 * n;
    tc.eosbb = meta + 3 * n; tc.soc = meta + 4 * n; tc.eoc = meta + 5 * n;
    tc.sbb_raster = meta + 6 * n;
    tc.sbb_right = tc.sbb_raster + tc.nsbb;
    tc.sbb_below = tc.sbb_right + tc.nsbb;
    for (int i = 0; i < n; i++) {
        int diag = tc.sx[i] + tc.sy[i];
        if (ch_luma) {
            tc.sig_off[i] = diag < 2 ? 8 : diag < 5 ? 4 : 0;
            tc.gtx_off[i] = diag < 1 ? 16 : diag < 3 ? 11
                            : diag < 10 ? 6 : 1;
        } else {
            tc.sig_off[i] = diag < 2 ? 4 : 0;
            tc.gtx_off[i] = diag < 1 ? 6 : 1;
        }
        tc.inside[i] = i & (tc.sbb - 1);
        tc.eosbb[i] = tc.inside[i] == 0;
        tc.soc[i] = tc.inside[i] == tc.sbb - 1 && i > tc.sbb && i < n - 1;
        tc.eoc[i] = tc.eosbb[i] && i > 0 && i < n - tc.sbb;
    }
    int hig = tc.nsbb / wig;
    for (int s = 0; s < tc.nsbb; s++) {
        int rp = tc.sbbpos[s], rpy = rp / wig, rpx = rp - rpy * wig;
        tc.sbb_raster[s] = rp;
        tc.sbb_right[s] = rpx < wig - 1 ? rp + 1 : 0;
        tc.sbb_below[s] = rpy < hig - 1 ? rp + wig : 0;
    }
    const int64_t *absc = (const int64_t *)b[0].buf;
    int32_t *lev = (int32_t *)b[1].buf;
    const int64_t *last = (const int64_t *)b[10].buf;
    const int32_t *sig = (const int32_t *)b[11].buf;
    const int32_t *gtx = (const int32_t *)b[12].buf;
    for (int t = 0; t < B; t++)
        run_one(&tc, absc + (size_t)t * n, last + (size_t)t * n,
                sig + (size_t)t * 38 * 2, gtx + (size_t)t * 21 * 6,
                lev + (size_t)t * n, dec_lv, dec_pv, planes);
    free(meta); free(dec_lv); free(dec_pv); free(planes);
    for (int j = 0; j < 13; j++) PyBuffer_Release(&b[j]);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"tcq_run", tcq_run, METH_VARARGS,
     "batched TCQ scan (native twin of tcq_scan.py)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef mod = {
    PyModuleDef_HEAD_INIT, "_vtm_torch_tcq", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit__vtm_torch_tcq(void) { return PyModule_Create(&mod); }
