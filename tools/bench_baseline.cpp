// Single-core CPU baseline for the pair-transducer Forward DP.
//
// Re-creates the computational shape of the reference implementation's
// hot loop (5-state composed-transducer Forward fill with lookup-table
// log-sum-exp over a dense profile-pair grid; see SURVEY.md 2.4) so the
// device kernel's throughput can be compared against an honest optimized
// single-core C++ rate measured on the same machine.
//
// Build: g++ -O3 -march=native -o bench_baseline bench_baseline.cpp
// Run:   ./bench_baseline <xlen> <ylen> <alphabet> <components> <reps>
// Output: cells-per-second (cells = xlen * ylen * 5)

// A second mode anchors the END-TO-END north star (BASELINE.json:
// "gp120 recon >= 10x single-core C++ at 1 host"):
//   ./bench_baseline recon <shapes-file>
// where each line of <shapes-file> is "X Y BAND_STATE_CELLS" -- the
// actual profile-pair merge shapes recorded from a real reconstruction
// (HISTORIAN_MERGE_SHAPES=<path> historian-tpu recon ...).  It runs the
// same single-core banded 5-state fill over every merge (A=20, C=1,
// per-row band window sized to the recorded band) and prints the TOTAL
// seconds: the time the reference's merge loop (recon.cpp:917-1052 over
// forward.cpp:78-203) would spend on this reconstruction's DP.  Fill
// only -- no traceback/profile surgery -- so the anchor UNDERSTATES the
// C++ cost and the reported speedup ratio is conservative.

// Two anchors are printed: an IDEALIZED dense-array fill (a lower bound
// for any single-core C++) and a REFERENCE-SHAPED fill that stores
// cells the way the reference does -- a per-row ordered map
// (forward.h:22 `cellStorage[x] : map<yIdx, XYCell>`), whose find/insert
// cost dominates the reference's real-world throughput (its published
// 233 s/BAliBase alignment implies ~1e6 cells/s vs the ~4e7 of the
// dense loop).

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <limits>
#include <map>
#include <vector>

static const int LOOKUP_ENTRIES = 100001;
static const double LOOKUP_MAX = 10.0, LOOKUP_PREC = 1e-4;
static std::vector<double> lut;

static void init_lut() {
  lut.resize(LOOKUP_ENTRIES + 1);
  for (int i = 0; i <= LOOKUP_ENTRIES; ++i)
    lut[i] = std::log(1.0 + std::exp(-i * LOOKUP_PREC));
}

static inline double lse2(double a, double b) {
  if (a < b) { double t = a; a = b; b = t; }
  const double d = a - b;
  if (d >= LOOKUP_MAX || b == -std::numeric_limits<double>::infinity()) return a;
  const int n = (int)(d / LOOKUP_PREC);
  const double f0 = lut[n], f1 = lut[n + 1];
  return a + f0 + (f1 - f0) * ((d - n * LOOKUP_PREC) / LOOKUP_PREC);
}

// One banded merge fill, IDEALIZED: dense row arrays, per-state rootsub/
// ins hoisted (as the reference hoists them, forward.cpp:44-56), per-cell
// work = one LINEAR-space absorb dot over A + the 5-state recurrence with
// lookup LSE.  This is a lower bound for any single-core C++.  Returns a
// value sink so the work cannot be dead-code-eliminated.  W = per-row
// band window (columns).
static double fill_banded(int X, int Y, int A, int C, long W, unsigned* seedp) {
  const double t_imm_imm = std::log(0.9), t_open = std::log(0.04), t_ext = std::log(0.4),
               t_close = std::log(0.55);
  const double NEG = -1e30;
  unsigned seed = *seedp;
  auto rnd = [&]() { seed = seed * 1103515245u + 12345u; return (seed >> 8) * (1.0 / 16777216.0); };
  std::vector<double> subx((size_t)(X + 1) * C * A), suby((size_t)(Y + 1) * C * A), root(C * A);
  for (auto& v : subx) v = rnd() + 1e-3;
  for (auto& v : suby) v = rnd() + 1e-3;
  for (auto& v : root) v = (rnd() + 1e-3) / (A * C);
  *seedp = seed;
  // hoisted per-state emission scores (the reference precomputes these)
  std::vector<double> lrsx(X + 1), lrsy(Y + 1);
  for (int i = 0; i <= X; ++i) {
    double s = 0;
    for (int c = 0; c < C; ++c)
      for (int a = 0; a < A; ++a) s += root[c * A + a] * subx[((size_t)i * C + c) * A + a];
    lrsx[i] = std::log(s);
  }
  for (int j = 0; j <= Y; ++j) {
    double s = 0;
    for (int c = 0; c < C; ++c)
      for (int a = 0; a < A; ++a) s += root[c * A + a] * suby[((size_t)j * C + c) * A + a];
    lrsy[j] = std::log(s);
  }
  std::vector<double> imm(Y + 1), imd(Y + 1), idm(Y + 1), imi(Y + 1), iiw(Y + 1);
  std::vector<double> p_imm(Y + 1, NEG), p_imd(Y + 1, NEG), p_idm(Y + 1, NEG),
      p_imi(Y + 1, NEG), p_iiw(Y + 1, NEG);
  p_imm[0] = 0;
  double sink = 0;
  for (int i = 1; i <= X; ++i) {
    const long jc = (long)i * Y / (X > 0 ? X : 1);
    const long jlo = jc - W / 2 < 1 ? 1 : jc - W / 2;
    const long jhi = jc + W / 2 + 1 > Y ? Y : jc + W / 2 + 1;
    for (long j = 0; j < jlo; ++j) imm[j] = imd[j] = idm[j] = imi[j] = iiw[j] = NEG;
    for (long j = jhi; j <= Y; ++j) imm[j] = imd[j] = idm[j] = imi[j] = iiw[j] = NEG;
    for (long j = jlo; j < jhi; ++j) {
      double absorb = 0;
      for (int c = 0; c < C; ++c)
        for (int a = 0; a < A; ++a) {
          const double r = root[c * A + a];
          absorb += r * subx[((size_t)i * C + c) * A + a] * suby[((size_t)j * C + c) * A + a];
        }
      const double labs = std::log(absorb);
      imm[j] = lse2(lse2(p_imm[j - 1] + t_imm_imm, p_imd[j - 1] + t_close),
                    lse2(p_idm[j - 1] + t_close,
                         lse2(p_imi[j - 1] + t_close, p_iiw[j - 1] + t_close))) + labs;
      imd[j] = lse2(lse2(p_imm[j] + t_open, p_imd[j] + t_ext),
                    lse2(p_idm[j] + t_close, p_imi[j] + t_close)) + lrsx[i];
      iiw[j] = lse2(lse2(p_imm[j] + t_open, p_imi[j] + t_close), p_iiw[j] + t_ext) + lrsx[i];
      idm[j] = lse2(lse2(imm[j - 1] + t_open, imd[j - 1] + t_close),
                    lse2(idm[j - 1] + t_ext, iiw[j - 1] + t_close)) + lrsy[j];
      imi[j] = lse2(imm[j - 1] + t_open, imi[j - 1] + t_ext) + lrsy[j];
    }
    std::swap(imm, p_imm); std::swap(imd, p_imd); std::swap(idm, p_idm);
    std::swap(imi, p_imi); std::swap(iiw, p_iiw);
    sink += p_imm[jhi - 1];
  }
  return sink;
}

// Reference-shaped variant of fill_banded: same recurrence, but with the
// reference's actual per-cell costs -- (a) cells live in a per-row
// ordered map and every source read is a map lookup (forward.h:22
// cellStorage), and (b) the match emission is computed per cell as a
// LOG-space inner product over the alphabet with lookup LSE
// (computeLogProbAbsorb, forward.h:112-124: A adds + A lse per cell),
// where the idealized variant uses one linear-space dot.
struct Cell5 { double v[5]; };

static double fill_banded_map(int X, int Y, int A, int C, long W, unsigned* seedp) {
  const double t_imm_imm = std::log(0.9), t_open = std::log(0.04), t_ext = std::log(0.4),
               t_close = std::log(0.55);
  const double NEG = -1e30;
  const double NINF = -std::numeric_limits<double>::infinity();
  unsigned seed = *seedp;
  auto rnd = [&]() { seed = seed * 1103515245u + 12345u; return (seed >> 8) * (1.0 / 16777216.0); };
  // log-space per-state absorb vectors (Profile lpAbsorb) + log root
  std::vector<double> lax((size_t)(X + 1) * C * A), lay((size_t)(Y + 1) * C * A), lroot(C * A);
  for (auto& v : lax) v = std::log(rnd() + 1e-3);
  for (auto& v : lay) v = std::log(rnd() + 1e-3);
  for (auto& v : lroot) v = std::log((rnd() + 1e-3) / (A * C));
  *seedp = seed;
  // hoisted per-state scores (forward.cpp:44-56)
  std::vector<double> lrsx(X + 1), lrsy(Y + 1);
  for (int i = 0; i <= X; ++i) {
    double s = NINF;
    for (int k = 0; k < C * A; ++k) s = lse2(s, lroot[k] + lax[(size_t)i * C * A + k]);
    lrsx[i] = s;
  }
  for (int j = 0; j <= Y; ++j) {
    double s = NINF;
    for (int k = 0; k < C * A; ++k) s = lse2(s, lroot[k] + lay[(size_t)j * C * A + k]);
    lrsy[j] = s;
  }
  enum { IMM, IMD, IDM, IMI, IIW };
  std::map<long, Cell5> prev, cur;
  Cell5 start; for (double& v : start.v) v = NEG; start.v[IMM] = 0;
  prev[0] = start;
  const Cell5 negc = [&]{ Cell5 c; for (double& v : c.v) v = NEG; return c; }();
  auto at = [&](std::map<long, Cell5>& row, long j) -> const Cell5& {
    auto it = row.find(j);
    return it == row.end() ? negc : it->second;
  };
  double sink = 0;
  for (int i = 1; i <= X; ++i) {
    const long jc = (long)i * Y / (X > 0 ? X : 1);
    const long jlo = jc - W / 2 < 1 ? 1 : jc - W / 2;
    const long jhi = jc + W / 2 + 1 > Y ? Y : jc + W / 2 + 1;
    cur.clear();
    for (long j = jlo; j < jhi; ++j) {
      // computeLogProbAbsorb: log-space inner product with lookup LSE
      double labs = NINF;
      for (int k = 0; k < C * A; ++k)
        labs = lse2(labs, lroot[k] + lax[(size_t)i * C * A + k] + lay[(size_t)j * C * A + k]);
      const Cell5& pd = at(prev, j - 1);   // diagonal source
      const Cell5& pu = at(prev, j);       // up source
      const Cell5& pl = at(cur, j - 1);    // left source
      Cell5 d;
      d.v[IMM] = lse2(lse2(pd.v[IMM] + t_imm_imm, pd.v[IMD] + t_close),
                      lse2(pd.v[IDM] + t_close,
                           lse2(pd.v[IMI] + t_close, pd.v[IIW] + t_close))) + labs;
      d.v[IMD] = lse2(lse2(pu.v[IMM] + t_open, pu.v[IMD] + t_ext),
                      lse2(pu.v[IDM] + t_close, pu.v[IMI] + t_close)) + lrsx[i];
      d.v[IIW] = lse2(lse2(pu.v[IMM] + t_open, pu.v[IMI] + t_close), pu.v[IIW] + t_ext) + lrsx[i];
      d.v[IDM] = lse2(lse2(pl.v[IMM] + t_open, pl.v[IMD] + t_close),
                      lse2(pl.v[IDM] + t_ext, pl.v[IIW] + t_close)) + lrsy[j];
      d.v[IMI] = lse2(pl.v[IMM] + t_open, pl.v[IMI] + t_ext) + lrsy[j];
      cur.emplace(j, d);
    }
    prev.swap(cur);
    if (!prev.empty()) sink += prev.rbegin()->second.v[IMM];
  }
  return sink;
}

static int recon_mode(const char* shapes_path) {
  init_lut();
  std::FILE* f = std::fopen(shapes_path, "r");
  if (!f) { std::fprintf(stderr, "cannot open %s\n", shapes_path); return 1; }
  std::vector<long> xs, ys, bands;
  long x, y, b;
  while (std::fscanf(f, "%ld %ld %ld", &x, &y, &b) == 3) {
    xs.push_back(x); ys.push_back(y); bands.push_back(b);
  }
  std::fclose(f);
  if (xs.empty()) { std::fprintf(stderr, "no shapes in %s\n", shapes_path); return 1; }
  unsigned seed = 12345;
  double sink = 0;
  auto t0 = std::chrono::steady_clock::now();
  for (size_t k = 0; k < xs.size(); ++k) {
    const long cells = bands[k] / 5;  // state-cells -> grid cells
    const long W = xs[k] > 0 ? (cells + xs[k] - 1) / xs[k] : 1;
    sink += fill_banded((int)xs[k], (int)ys[k], 20, 1, W < 1 ? 1 : W, &seed);
  }
  auto t1 = std::chrono::steady_clock::now();
  seed = 12345;
  for (size_t k = 0; k < xs.size(); ++k) {
    const long cells = bands[k] / 5;
    const long W = xs[k] > 0 ? (cells + xs[k] - 1) / xs[k] : 1;
    sink += fill_banded_map((int)xs[k], (int)ys[k], 20, 1, W < 1 ? 1 : W, &seed);
  }
  auto t2 = std::chrono::steady_clock::now();
  // line 1: idealized dense-array seconds; line 2: reference-shaped
  // (per-row map cellStorage) seconds
  std::printf("%.6g\n%.6g\n",
              std::chrono::duration<double>(t1 - t0).count(),
              std::chrono::duration<double>(t2 - t1).count());
  std::fprintf(stderr, "merges=%zu sink=%g\n", xs.size(), sink);
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 3 && std::strcmp(argv[1], "recon") == 0) return recon_mode(argv[2]);
  if (argc != 6) { std::fprintf(stderr, "usage: %s xlen ylen A C reps | %s recon shapes.txt\n", argv[0], argv[0]); return 1; }
  const int X = std::atoi(argv[1]), Y = std::atoi(argv[2]);
  const int A = std::atoi(argv[3]), C = std::atoi(argv[4]), reps = std::atoi(argv[5]);
  init_lut();

  // random emission profiles (linear space) and substitution matrices
  std::vector<double> xprof((X + 1) * C * A), yprof((Y + 1) * C * A);
  std::vector<double> sub(C * A * A), root(C * A);
  unsigned seed = 12345;
  auto rnd = [&]() { seed = seed * 1103515245u + 12345u; return (seed >> 8) * (1.0 / 16777216.0); };
  for (auto& v : xprof) v = rnd() + 1e-3;
  for (auto& v : yprof) v = rnd() + 1e-3;
  for (auto& v : sub) v = rnd() + 1e-3;
  for (auto& v : root) v = (rnd() + 1e-3) / (A * C);

  const double t_imm_imm = std::log(0.9), t_open = std::log(0.04), t_ext = std::log(0.4),
               t_close = std::log(0.55);
  const double NEG = -1e30;

  // precompute per-state emission scores the way the reference does
  // (forward.cpp:44-56): subx = leftMultiply, then inner products per pair
  std::vector<double> subx((X + 1) * C * A), suby((Y + 1) * C * A);
  auto leftmul = [&](const std::vector<double>& prof, std::vector<double>& out, int N) {
    for (int i = 0; i <= N; ++i)
      for (int c = 0; c < C; ++c)
        for (int a = 0; a < A; ++a) {
          double s = 0;
          for (int d = 0; d < A; ++d)
            s += sub[(c * A + a) * A + d] * prof[(i * C + c) * A + d];
          out[(i * C + c) * A + a] = s;
        }
  };

  std::vector<double> imm((Y + 1)), imd(Y + 1), idm(Y + 1), imi(Y + 1), iiw(Y + 1);
  std::vector<double> p_imm(Y + 1), p_imd(Y + 1), p_idm(Y + 1), p_imi(Y + 1), p_iiw(Y + 1);

  double sink = 0;
  auto t0 = std::chrono::steady_clock::now();
  for (int rep = 0; rep < reps; ++rep) {
    leftmul(xprof, subx, X);
    leftmul(yprof, suby, Y);
    for (int j = 0; j <= Y; ++j) p_imm[j] = p_imd[j] = p_idm[j] = p_imi[j] = p_iiw[j] = NEG;
    p_imm[0] = 0;
    for (int i = 1; i <= X; ++i) {
      imm[0] = imd[0] = idm[0] = imi[0] = iiw[0] = NEG;
      for (int j = 1; j <= Y; ++j) {
        // emission inner products over components x alphabet (the FLOPs)
        double absorb = 0, rsx = 0, rsy = 0;
        for (int c = 0; c < C; ++c)
          for (int a = 0; a < A; ++a) {
            const double r = root[c * A + a];
            const double sx = subx[(i * C + c) * A + a];
            const double sy = suby[(j * C + c) * A + a];
            absorb += r * sx * sy;
            rsx += r * sx;
            rsy += r * sy;
          }
        const double labs = std::log(absorb), lrsx = std::log(rsx), lrsy = std::log(rsy);
        imm[j] = lse2(lse2(p_imm[j - 1] + t_imm_imm, p_imd[j - 1] + t_close),
                      lse2(p_idm[j - 1] + t_close,
                           lse2(p_imi[j - 1] + t_close, p_iiw[j - 1] + t_close))) + labs;
        imd[j] = lse2(lse2(p_imm[j] + t_open, p_imd[j] + t_ext),
                      lse2(p_idm[j] + t_close, p_imi[j] + t_close)) + lrsx;
        iiw[j] = lse2(lse2(p_imm[j] + t_open, p_imi[j] + t_close), p_iiw[j] + t_ext) + lrsx;
        idm[j] = lse2(lse2(imm[j - 1] + t_open, imd[j - 1] + t_close),
                      lse2(idm[j - 1] + t_ext, iiw[j - 1] + t_close)) + lrsy;
        imi[j] = lse2(imm[j - 1] + t_open, imi[j - 1] + t_ext) + lrsy;
      }
      std::swap(imm, p_imm); std::swap(imd, p_imd); std::swap(idm, p_idm);
      std::swap(imi, p_imi); std::swap(iiw, p_iiw);
    }
    sink += p_imm[Y];
  }
  auto t1 = std::chrono::steady_clock::now();
  const double secs = std::chrono::duration<double>(t1 - t0).count();
  const double cells = (double)X * Y * 5 * reps;
  std::printf("%.6g\n", cells / secs);
  std::fprintf(stderr, "sink=%g secs=%g\n", sink, secs);
  return 0;
}
