// Columnar TPC-H data generator for the TPU-native query engine.
//
// Produces TPC-H tables directly as columnar buffers (int64/int32 numerics,
// epoch-day dates, fixed-width zero-padded byte strings) so the Python side
// can upload them straight to device memory without row pivoting.
//
// The row-content algorithm follows the normative TPC-H specification data
// generator ("dbgen", Park-Miller minimum-standard RNG with per-column
// streams, per-row seed boundaries, and the ELIZA-style text pool), so that
// generated tables are bit-identical to the reference engine's loader and the
// published golden answers apply.  Spec constants (per-stream seeds and
// boundaries, field length limits, date window) are from the TPC-H spec; see
// reference extension/tpch/dbgen/{build.cpp,bm_utils.cpp,text.cpp,rnd.cpp,
// speed_seed.cpp, include/dbgen/dss.h} for the corresponding reference code.
// The architecture here is new: columnar output, chunk/offset addressable
// generation (for partitioned multi-host ingest), no global mutable state.
//
// Build:  g++ -O2 -shared -fPIC -o libtpchgen.so tpch_dbgen.cpp
//
// The benchmark's frozen copy of the engine's generator.  One addition:
// `tpg_set_order_keys` makes the next orders/lineitem call key its rows from
// a given index and sparse-key sequence number, as dbgen's update sets do
// (TPC-H clause 4.2.3: new orders take keys the base population leaves
// unused).  With the default (-1, 0) it generates exactly the base rows.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>
#include <map>

namespace {

using i64 = long long;

// ---------------------------------------------------------------- RNG core
constexpr i64 kMult = 16807;
constexpr i64 kMod = 2147483647;
constexpr double kModF = 2147483647.0;
constexpr i64 kMaxLong = 0x7FFFFFFF;

inline i64 rng_next(i64 s) { return (s * kMult) % kMod; }

// seed after n applications of the generator (divide & conquer modpow)
i64 rng_jump(i64 seed, i64 n) {
  i64 mult = kMult;
  i64 z = seed;
  while (n > 0) {
    if (n & 1) z = (mult * z) % kMod;
    n >>= 1;
    mult = (mult * mult) % kMod;
  }
  return z;
}

// One per-column RNG stream with per-row call bookkeeping.  After every row
// the stream is advanced to a fixed per-row boundary so row N's values are
// independent of how many draws row N-1 actually used.
struct Stream {
  i64 value = 0;
  i64 usage = 0;
  i64 boundary = 1;

  i64 uniform(i64 lo, i64 hi) {
    double range = (hi == kMaxLong && lo == 0)
                       ? (double)((i64)((int32_t)hi - (int32_t)lo) + 1)
                       : (double)(hi - lo + 1);
    value = rng_next(value);
    usage += 1;
    i64 t = (i64)(((double)value / kModF) * range);
    return lo + t;
  }
  void finish_row() {
    value = rng_jump(value, boundary - usage);
    usage = 0;
  }
  void skip_rows(i64 rows) { value = rng_jump(value, boundary * rows); }
};

// stream ids (TPC-H spec stream numbering)
enum {
  SD_P_MFG = 0, SD_P_BRND, SD_P_TYPE, SD_P_SIZE, SD_P_CNTR, SD_TEXTPOOL,
  SD_P_CMNT, SD_PS_QTY, SD_PS_SCST, SD_PS_CMNT, SD_O_SUPP, SD_O_CLRK,
  SD_O_CMNT, SD_O_ODATE, SD_L_QTY, SD_L_DCNT, SD_L_TAX, SD_L_SHIP,
  SD_L_SMODE, SD_L_PKEY, SD_L_SKEY, SD_L_SDTE, SD_L_CDTE, SD_L_RDTE,
  SD_L_RFLG, SD_L_CMNT, SD_C_ADDR, SD_C_NTRG, SD_C_PHNE, SD_C_ABAL,
  SD_C_MSEG, SD_C_CMNT, SD_S_ADDR, SD_S_NTRG, SD_S_PHNE, SD_S_ABAL,
  SD_S_CMNT, SD_P_NAME, SD_O_PRIO, SD_HVAR, SD_O_CKEY, SD_N_CMNT,
  SD_R_CMNT, SD_O_LCNT, SD_BBB_JNK, SD_BBB_TYPE, SD_BBB_CMNT, SD_BBB_OFFSET,
  NUM_STREAMS
};

struct SeedSpec { i64 seed; i64 boundary; };
// initial seed value and per-row draw boundary for each stream (TPC-H spec)
constexpr SeedSpec kSeeds[NUM_STREAMS] = {
    {1, 1},          {46831694, 1},   {1841581359, 1}, {1193163244, 1},
    {727633698, 1},  {933588178, 1},  {804159733, 2},  {1671059989, 4},
    {1051288424, 4}, {1961692154, 8}, {1227283347, 1}, {1171034773, 1},
    {276090261, 2},  {1066728069, 1}, {209208115, 7},  {554590007, 7},
    {721958466, 7},  {1371272478, 7}, {675466456, 7},  {1808217256, 7},
    {2095021727, 7}, {1769349045, 7}, {904914315, 7},  {373135028, 7},
    {717419739, 7},  {1095462486, 14},{881155353, 9},  {1489529863, 1},
    {1521138112, 3}, {298370230, 1},  {1140279430, 1}, {1335826707, 2},
    {706178559, 9},  {110356601, 1},  {884434366, 3},  {962338209, 1},
    {1341315363, 2}, {709314158, 92}, {591449447, 1},  {431918286, 1},
    {851767375, 1},  {606179079, 2},  {1500869201, 2}, {1434868289, 1},
    {263032577, 1},  {753643799, 1},  {202794285, 1},  {715851524, 1},
};

// ------------------------------------------------------------ distributions
struct Dist {
  std::vector<std::string> text;
  std::vector<i64> cum;  // cumulative weights
  i64 max_cum = 0;

  int pick(Stream& s) const {
    i64 j = s.uniform(1, max_cum);
    int i = 0;
    while (cum[i] < j) i++;
    return i;
  }
};

struct Gen;

// spec date window: day index 92001 == 1992-01-01 (epoch day 8035)
constexpr i64 kStartDate = 92001;
constexpr i64 kCurrentDate = 95168;  // in yyddd "julian" form
constexpr i64 kTotDate = 2557;
constexpr i64 kEpochBase = 8035;  // unix epoch days of 1992-01-01

inline bool is_leap(i64 y) { return (y % 4 == 0) && (y % 100 != 0); }

// convert linear day index (kStartDate-based) to spec yyddd "julian" form
i64 to_julian(i64 idx) {
  i64 offset = idx - kStartDate;
  i64 result = kStartDate;
  while (true) {
    i64 yr = result / 1000;
    i64 yend = yr * 1000 + 365 + (is_leap(yr) ? 1 : 0);
    if (result + offset > yend) {
      offset -= yend - result + 1;
      result += 1000;
    } else {
      break;
    }
  }
  return result + offset;
}

constexpr const char* kAlphaNum =
    "0123456789abcdefghijklmnopqrstuvwxyz ABCDEFGHIJKLMNOPQRSTUVWXYZ,";

struct Gen {
  std::map<std::string, Dist> dists;
  Dist *d_p_cntr, *d_colors, *d_p_types, *d_nations, *d_regions, *d_o_prio,
      *d_instruct, *d_smode, *d_rflag, *d_mseg, *d_nouns, *d_verbs, *d_adj,
      *d_adv, *d_aux, *d_term, *d_prep, *d_grammar, *d_np, *d_vp;

  std::vector<char> pool;
  i64 pool_size = 0;

  Stream st[NUM_STREAMS];
  double sf = 1.0;
  i64 scale = 1;  // integer scale factor (>= 1)
  i64 base[6];    // prescaled base rowcounts: PART PSUPP SUPP CUST ORDER LINE

  int permute_buf[256];

  void reset_streams() {
    for (int i = 0; i < NUM_STREAMS; i++) {
      st[i].value = kSeeds[i].seed;
      st[i].usage = 0;
      st[i].boundary = kSeeds[i].boundary;
    }
  }

  void init(double sf_) {
    sf = sf_;
    i64 b[6] = {200000, 200000, 10000, 150000, 1500000, 1500000};
    if (sf < 1.0) {
      scale = 1;
      i64 int_scale = (i64)(1000 * sf);
      for (int i = 0; i < 6; i++) {
        b[i] = (int_scale * b[i]) / 1000;
        if (b[i] < 1) b[i] = 1;
      }
    } else {
      scale = (i64)sf;
    }
    for (int i = 0; i < 6; i++) base[i] = b[i];
    reset_streams();
    build_pool(10 * 1024 * 1024);
    reset_streams();  // pool build consumed stream 5 only, but be tidy
  }

  i64 rows_part() const { return base[0] * (sf < 1.0 ? 1 : scale); }
  i64 rows_supp() const { return base[2] * (sf < 1.0 ? 1 : scale); }
  i64 rows_cust() const { return base[3] * (sf < 1.0 ? 1 : scale); }
  i64 rows_order() const { return base[4] * (sf < 1.0 ? 1 : scale); }

  // ------------------------------------------------------------ text pool
  // ELIZA-style pseudo-text: grammar-driven sentence generation feeding a
  // shared pool; comments are random [offset,len) slices of the pool.
  char* write_word(char* p, const Dist& d, Stream& s) {
    int i = d.pick(s);
    const std::string& w = d.text[i];
    memcpy(p, w.data(), w.size());
    p += w.size();
    *p++ = ' ';
    return p;
  }

  char* gen_np(char* p, Stream& s) {
    int idx = d_np->pick(s);
    switch (idx) {
      case 0:
        p = write_word(p, *d_nouns, s);
        break;
      case 1:
        p = write_word(p, *d_adj, s);
        p = write_word(p, *d_nouns, s);
        break;
      case 2:
        p = write_word(p, *d_adj, s);
        p[-1] = ',';
        *p++ = ' ';
        p = write_word(p, *d_adj, s);
        p = write_word(p, *d_nouns, s);
        break;
      default:
        p = write_word(p, *d_adv, s);
        p = write_word(p, *d_adj, s);
        p = write_word(p, *d_nouns, s);
        break;
    }
    return p;
  }

  char* gen_vp(char* p, Stream& s) {
    int idx = d_vp->pick(s);
    switch (idx) {
      case 0:
        p = write_word(p, *d_verbs, s);
        break;
      case 1:
        p = write_word(p, *d_aux, s);
        p = write_word(p, *d_verbs, s);
        break;
      case 2:
        p = write_word(p, *d_verbs, s);
        p = write_word(p, *d_adv, s);
        break;
      default:
        p = write_word(p, *d_aux, s);
        p = write_word(p, *d_verbs, s);
        p = write_word(p, *d_adv, s);
        break;
    }
    return p;
  }

  char* gen_prep_phrase(char* p, Stream& s) {
    p = write_word(p, *d_prep, s);
    memcpy(p, "the ", 4);
    p += 4;
    return gen_np(p, s);
  }

  // terminator abuts the previous word: back over the trailing space
  char* gen_terminator(char* p, Stream& s) {
    p -= 1;
    p = write_word(p, *d_term, s);
    return p - 1;
  }

  char* gen_sentence(char* p, Stream& s) {
    int idx = d_grammar->pick(s);
    switch (idx) {
      case 0:
        p = gen_np(p, s);
        p = gen_vp(p, s);
        p = gen_terminator(p, s);
        break;
      case 1:
        p = gen_np(p, s);
        p = gen_vp(p, s);
        p = gen_prep_phrase(p, s);
        p = gen_terminator(p, s);
        break;
      case 2:
        p = gen_np(p, s);
        p = gen_vp(p, s);
        p = gen_np(p, s);
        p = gen_terminator(p, s);
        break;
      case 3:
        p = gen_np(p, s);
        p = gen_prep_phrase(p, s);
        p = gen_vp(p, s);
        p = gen_np(p, s);
        p = gen_terminator(p, s);
        break;
      default:
        p = gen_np(p, s);
        p = gen_prep_phrase(p, s);
        p = gen_vp(p, s);
        p = gen_prep_phrase(p, s);
        p = gen_terminator(p, s);
        break;
    }
    *p = ' ';
    return p + 1;
  }

  void build_pool(i64 bytes) {
    pool_size = bytes;
    pool.assign(bytes + 1 + 400, 0);
    char* p = pool.data();
    char* end = pool.data() + bytes + 1;
    Stream& s = st[SD_TEXTPOOL];
    while (p < end) p = gen_sentence(p, s);
    pool[bytes] = '\0';
  }

  // comment: 2 draws (offset, length), then slice of the pool
  int text(char* dst, int min_len, int max_len, Stream& s) {
    i64 off = s.uniform(0, pool_size - max_len);
    i64 len = s.uniform(min_len, max_len);
    memcpy(dst, pool.data() + off, len);
    return (int)len;
  }

  // random alphanumeric string, 1 draw for length + 1 draw per 5 chars
  int a_rnd(char* dst, int min_len, int max_len, Stream& s) {
    i64 len = s.uniform(min_len, max_len);
    i64 char_int = 0;
    for (i64 i = 0; i < len; i++) {
      if (i % 5 == 0) char_int = s.uniform(0, kMaxLong);
      dst[i] = kAlphaNum[char_int & 077];
      char_int >>= 6;
    }
    return (int)len;
  }

  int phone(char* dst, i64 nation, Stream& s) {
    i64 acode = s.uniform(100, 999);
    i64 exchg = s.uniform(100, 999);
    i64 number = s.uniform(1000, 9999);
    snprintf(dst, 16, "%02d-%03d-%03d-%04d", (int)(10 + nation % 90),
             (int)acode, (int)exchg, (int)number);
    return 15;
  }

  // part name: space-joined prefix of a fresh permutation of the colors set
  int agg_colors(char* dst, int count, Stream& s) {
    int n = (int)d_colors->text.size();
    for (int i = 0; i < n; i++) permute_buf[i] = i;
    for (int i = 0; i < n; i++) {
      i64 src = s.uniform(i, n - 1);
      std::swap(permute_buf[src], permute_buf[i]);
    }
    char* p = dst;
    for (int i = 0; i < count; i++) {
      const std::string& w = d_colors->text[permute_buf[i]];
      memcpy(p, w.data(), w.size());
      p += w.size();
      *p++ = ' ';
    }
    return (int)(p - dst - 1);
  }
};

Gen g;

inline void put_str(char* col, i64 row, int width, const char* src, int len) {
  char* dst = col + row * width;
  memset(dst, 0, width);
  memcpy(dst, src, len);
}

// retail price base routine (deterministic in the part key)
inline i64 retail_price(i64 p) {
  return 90000 + (p / 10) % 20001 + (p % 1000) * 100;
}

// part/supplier bridge: the 4 suppliers of part p
inline i64 part_supp_bridge(i64 p, i64 snum, i64 tot_scnt) {
  return (p + snum * (tot_scnt / 4 + (p - 1) / tot_scnt)) % tot_scnt + 1;
}

// sparse order keys: 2 spare bits above the low 3
inline i64 sparse_key(i64 i, i64 seq) {
  i64 low = i & 7;
  return ((((i >> 3) << 2) | (seq & 3)) << 3) | low;
}

// orders/lineitem key map: -1 keys each row by its own index, seq 0
i64 g_key_start = -1;
i64 g_key_seq = 0;

}  // namespace

extern "C" {

void tpg_set_order_keys(i64 key_start, i64 seq) {
  g_key_start = key_start;
  g_key_seq = seq;
}

void tpg_load_dist(const char* name, int count, const char* concat,
                   const int* offsets, const i64* weights) {
  Dist d;
  i64 cum = 0;
  for (int i = 0; i < count; i++) {
    d.text.emplace_back(concat + offsets[i], concat + offsets[i + 1]);
    cum += weights[i];
    d.cum.push_back(cum);
  }
  d.max_cum = cum;
  g.dists[name] = std::move(d);
}

int tpg_init(double sf) {
  auto need = [&](const char* n) -> Dist* {
    auto it = g.dists.find(n);
    if (it == g.dists.end()) return nullptr;
    return &it->second;
  };
  g.d_p_cntr = need("p_cntr");
  g.d_colors = need("colors");
  g.d_p_types = need("p_types");
  g.d_nations = need("nations");
  g.d_regions = need("regions");
  g.d_o_prio = need("o_oprio");
  g.d_instruct = need("instruct");
  g.d_smode = need("smode");
  g.d_rflag = need("rflag");
  g.d_mseg = need("msegmnt");
  g.d_nouns = need("nouns");
  g.d_verbs = need("verbs");
  g.d_adj = need("adjectives");
  g.d_adv = need("adverbs");
  g.d_aux = need("auxillaries");
  g.d_term = need("terminators");
  g.d_prep = need("prepositions");
  g.d_grammar = need("grammar");
  g.d_np = need("np");
  g.d_vp = need("vp");
  if (!g.d_p_cntr || !g.d_colors || !g.d_p_types || !g.d_nations ||
      !g.d_regions || !g.d_o_prio || !g.d_instruct || !g.d_smode ||
      !g.d_rflag || !g.d_mseg || !g.d_nouns || !g.d_verbs || !g.d_adj ||
      !g.d_adv || !g.d_aux || !g.d_term || !g.d_prep || !g.d_grammar ||
      !g.d_np || !g.d_vp)
    return -1;
  g.init(sf);
  return 0;
}

i64 tpg_rows(int table) {
  // 0 part 1 partsupp 2 supplier 3 customer 4 orders 8 nation 9 region
  switch (table) {
    case 0: return g.rows_part();
    case 1: return g.rows_part() * 4;
    case 2: return g.rows_supp();
    case 3: return g.rows_cust();
    case 4: return g.rows_order();
    case 8: return (i64)g.d_nations->text.size();
    case 9: return (i64)g.d_regions->text.size();
    default: return -1;
  }
}

// ------------------------------------------------------------------ region
void tpg_gen_region(int32_t* key, char* name, char* comment /*w=116*/) {
  Stream& cm = g.st[SD_R_CMNT];
  cm.value = kSeeds[SD_R_CMNT].seed;
  cm.usage = 0;
  char buf[256];
  int n = (int)g.d_regions->text.size();
  for (int i = 0; i < n; i++) {
    key[i] = i;
    const std::string& t = g.d_regions->text[i];
    put_str(name, i, 26, t.data(), (int)t.size());
    int len = g.text(buf, (int)(72 * 0.4), (int)(72 * 1.6), cm);
    put_str(comment, i, 116, buf, len);
    cm.finish_row();
  }
}

// ------------------------------------------------------------------ nation
void tpg_gen_nation(int32_t* key, char* name, int32_t* region,
                    char* comment /*w=116*/) {
  Stream& cm = g.st[SD_N_CMNT];
  cm.value = kSeeds[SD_N_CMNT].seed;
  cm.usage = 0;
  char buf[256];
  int n = (int)g.d_nations->text.size();
  for (int i = 0; i < n; i++) {
    key[i] = i;
    const std::string& t = g.d_nations->text[i];
    put_str(name, i, 26, t.data(), (int)t.size());
    // region key is the running sum of the nation weights (spec encoding)
    region[i] = (int32_t)g.d_nations->cum[i];
    int len = g.text(buf, (int)(72 * 0.4), (int)(72 * 1.6), cm);
    put_str(comment, i, 116, buf, len);
    cm.finish_row();
  }
}

// ---------------------------------------------------------------- supplier
// widths: name 26, address 40, phone 16, comment 104
void tpg_gen_supplier(i64 start, i64 count, i64* key, char* name,
                      char* address, int32_t* nation, char* phone,
                      i64* acctbal, char* comment) {
  static const int ids[] = {SD_S_ADDR, SD_S_NTRG, SD_S_PHNE, SD_S_ABAL,
                            SD_S_CMNT, SD_BBB_JNK, SD_BBB_TYPE, SD_BBB_CMNT,
                            SD_BBB_OFFSET};
  for (int id : ids) {
    g.st[id].value = kSeeds[id].seed;
    g.st[id].usage = 0;
    g.st[id].skip_rows(start);
  }
  char buf[256];
  for (i64 r = 0; r < count; r++) {
    i64 idx = start + r + 1;
    key[r] = idx;
    snprintf(buf, sizeof(buf), "Supplier#%09lld", idx);
    put_str(name, r, 26, buf, (int)strlen(buf));
    int alen = g.a_rnd(buf, (int)(25 * 0.4), (int)(25 * 1.6), g.st[SD_S_ADDR]);
    put_str(address, r, 40, buf, alen);
    i64 nat = g.st[SD_S_NTRG].uniform(0, (i64)g.d_nations->text.size() - 1);
    nation[r] = (int32_t)nat;
    g.phone(buf, nat, g.st[SD_S_PHNE]);
    put_str(phone, r, 16, buf, 15);
    acctbal[r] = g.st[SD_S_ABAL].uniform(-99999, 999999);
    int clen = g.text(buf, (int)(63 * 0.4), (int)(63 * 1.6), g.st[SD_S_CMNT]);
    // "Better Business Bureau" overwrite: 10 complaints/commendations per SF
    i64 bad_press = g.st[SD_BBB_CMNT].uniform(1, 10000);
    i64 type = g.st[SD_BBB_TYPE].uniform(0, 100);
    i64 noise = g.st[SD_BBB_JNK].uniform(0, clen - 19);
    i64 offset = g.st[SD_BBB_OFFSET].uniform(0, clen - (19 + noise));
    if (bad_press <= 10) {
      memcpy(buf + offset, "Customer ", 9);
      memcpy(buf + 9 + offset + noise, type < 50 ? "Complaints" : "Recommends",
             10);
    }
    put_str(comment, r, 104, buf, clen);
    for (int id : ids) g.st[id].finish_row();
  }
}

// ---------------------------------------------------------------- customer
// widths: name 26, address 40, phone 16, mktsegment 12, comment 120
void tpg_gen_customer(i64 start, i64 count, i64* key, char* name,
                      char* address, int32_t* nation, char* phone,
                      i64* acctbal, char* mktsegment, char* comment) {
  static const int ids[] = {SD_C_ADDR, SD_C_NTRG, SD_C_PHNE,
                            SD_C_ABAL, SD_C_MSEG, SD_C_CMNT};
  for (int id : ids) {
    g.st[id].value = kSeeds[id].seed;
    g.st[id].usage = 0;
    g.st[id].skip_rows(start);
  }
  char buf[256];
  for (i64 r = 0; r < count; r++) {
    i64 idx = start + r + 1;
    key[r] = idx;
    snprintf(buf, sizeof(buf), "Customer#%09lld", idx);
    put_str(name, r, 26, buf, (int)strlen(buf));
    int alen = g.a_rnd(buf, (int)(25 * 0.4), (int)(25 * 1.6), g.st[SD_C_ADDR]);
    put_str(address, r, 40, buf, alen);
    i64 nat = g.st[SD_C_NTRG].uniform(0, (i64)g.d_nations->text.size() - 1);
    nation[r] = (int32_t)nat;
    g.phone(buf, nat, g.st[SD_C_PHNE]);
    put_str(phone, r, 16, buf, 15);
    acctbal[r] = g.st[SD_C_ABAL].uniform(-99999, 999999);
    int mi = g.d_mseg->pick(g.st[SD_C_MSEG]);
    put_str(mktsegment, r, 12, g.d_mseg->text[mi].data(),
            (int)g.d_mseg->text[mi].size());
    int clen = g.text(buf, (int)(73 * 0.4), (int)(73 * 1.6), g.st[SD_C_CMNT]);
    put_str(comment, r, 120, buf, clen);
    for (int id : ids) g.st[id].finish_row();
  }
}

// ------------------------------------------------------------ part+partsupp
// part widths: name 56, mfgr 26, brand 12, type 26, container 12, comment 24
// partsupp widths: comment 200; psupp arrays sized count*4
void tpg_gen_part_psupp(i64 start, i64 count, i64* p_key, char* p_name,
                        char* p_mfgr, char* p_brand, char* p_type,
                        int32_t* p_size, char* p_container, i64* p_retail,
                        char* p_comment, i64* ps_partkey, i64* ps_suppkey,
                        i64* ps_availqty, i64* ps_supplycost,
                        char* ps_comment) {
  static const int pids[] = {SD_P_MFG, SD_P_BRND, SD_P_TYPE, SD_P_SIZE,
                             SD_P_CNTR, SD_P_CMNT, SD_P_NAME};
  static const int sids[] = {SD_PS_QTY, SD_PS_SCST, SD_PS_CMNT};
  for (int id : pids) {
    g.st[id].value = kSeeds[id].seed;
    g.st[id].usage = 0;
    g.st[id].skip_rows(start);
  }
  for (int id : sids) {
    g.st[id].value = kSeeds[id].seed;
    g.st[id].usage = 0;
    g.st[id].skip_rows(start);
  }
  i64 tot_scnt = g.base[2] * (g.sf < 1.0 ? 1 : g.scale);
  char buf[256];
  for (i64 r = 0; r < count; r++) {
    i64 idx = start + r + 1;
    p_key[r] = idx;
    int nlen = g.agg_colors(buf, 5, g.st[SD_P_NAME]);
    put_str(p_name, r, 56, buf, nlen);
    i64 mfg = g.st[SD_P_MFG].uniform(1, 5);
    snprintf(buf, sizeof(buf), "Manufacturer#%01lld", mfg);
    put_str(p_mfgr, r, 26, buf, (int)strlen(buf));
    i64 brnd = g.st[SD_P_BRND].uniform(1, 5);
    snprintf(buf, sizeof(buf), "Brand#%02lld", mfg * 10 + brnd);
    put_str(p_brand, r, 12, buf, (int)strlen(buf));
    int ti = g.d_p_types->pick(g.st[SD_P_TYPE]);
    put_str(p_type, r, 26, g.d_p_types->text[ti].data(),
            (int)g.d_p_types->text[ti].size());
    p_size[r] = (int32_t)g.st[SD_P_SIZE].uniform(1, 50);
    int ci = g.d_p_cntr->pick(g.st[SD_P_CNTR]);
    put_str(p_container, r, 12, g.d_p_cntr->text[ci].data(),
            (int)g.d_p_cntr->text[ci].size());
    p_retail[r] = retail_price(idx);
    int clen = g.text(buf, (int)(14 * 0.4), (int)(14 * 1.6), g.st[SD_P_CMNT]);
    put_str(p_comment, r, 24, buf, clen);

    for (i64 snum = 0; snum < 4; snum++) {
      i64 pr = r * 4 + snum;
      ps_partkey[pr] = idx;
      ps_suppkey[pr] = part_supp_bridge(idx, snum, tot_scnt);
      ps_availqty[pr] = g.st[SD_PS_QTY].uniform(1, 9999);
      ps_supplycost[pr] = g.st[SD_PS_SCST].uniform(100, 100000);
      int pslen =
          g.text(buf, (int)(124 * 0.4), (int)(124 * 1.6), g.st[SD_PS_CMNT]);
      put_str(ps_comment, pr, 200, buf, pslen);
    }
    for (int id : pids) g.st[id].finish_row();
    for (int id : sids) g.st[id].finish_row();
  }
}

// --------------------------------------------------------- orders+lineitem
// orders widths: orderpriority 16, clerk 16, comment 80
// lineitem widths: shipinstruct 26, shipmode 12, comment 44
// lineitem arrays sized count*7; returns number of lineitem rows produced.
i64 tpg_gen_orders_lineitem(
    i64 start, i64 count,
    // orders columns
    i64* o_orderkey, i64* o_custkey, uint8_t* o_orderstatus, i64* o_totalprice,
    int32_t* o_orderdate, char* o_orderpriority, char* o_clerk,
    int32_t* o_shippriority, char* o_comment,
    // lineitem columns
    i64* l_orderkey, i64* l_partkey, i64* l_suppkey, i64* l_linenumber,
    i64* l_quantity, i64* l_extendedprice, i64* l_discount, i64* l_tax,
    uint8_t* l_returnflag, uint8_t* l_linestatus, int32_t* l_shipdate,
    int32_t* l_commitdate, int32_t* l_receiptdate, char* l_shipinstruct,
    char* l_shipmode, char* l_comment) {
  static const int oids[] = {SD_O_SUPP, SD_O_CLRK, SD_O_CMNT, SD_O_ODATE,
                             SD_O_PRIO, SD_O_CKEY, SD_O_LCNT};
  static const int lids[] = {SD_L_QTY, SD_L_DCNT, SD_L_TAX,  SD_L_SHIP,
                             SD_L_SMODE, SD_L_PKEY, SD_L_SKEY, SD_L_SDTE,
                             SD_L_CDTE, SD_L_RDTE, SD_L_RFLG, SD_L_CMNT,
                             SD_HVAR};
  for (int id : oids) {
    g.st[id].value = kSeeds[id].seed;
    g.st[id].usage = 0;
    g.st[id].skip_rows(start);
  }
  for (int id : lids) {
    g.st[id].value = kSeeds[id].seed;
    g.st[id].usage = 0;
    g.st[id].skip_rows(start);
  }
  i64 ckey_max = g.base[3] * (g.sf < 1.0 ? 1 : g.scale);
  i64 pkey_max = g.base[0] * (g.sf < 1.0 ? 1 : g.scale);
  i64 tot_scnt = g.base[2] * (g.sf < 1.0 ? 1 : g.scale);
  i64 clerk_max = g.scale * 1000 > 1000 ? g.scale * 1000 : 1000;
  i64 odate_max = kStartDate + kTotDate - (121 + 30) - 1;
  char buf[256];
  i64 lrow = 0;
  for (i64 r = 0; r < count; r++) {
    i64 idx = start + r + 1;
    i64 okey = g_key_start < 0 ? sparse_key(idx, 0)
                               : sparse_key(g_key_start + r + 1, g_key_seq);
    o_orderkey[r] = okey;
    i64 ckey = g.st[SD_O_CKEY].uniform(1, ckey_max);
    // skip the third of customers that never order
    i64 delta = 1;
    while (ckey % 3 == 0) {
      ckey += delta;
      ckey = ckey < ckey_max ? ckey : ckey_max;
      delta *= -1;
    }
    o_custkey[r] = ckey;
    i64 tmp_date = g.st[SD_O_ODATE].uniform(kStartDate, odate_max);
    o_orderdate[r] = (int32_t)(tmp_date - kStartDate + kEpochBase);
    int pi = g.d_o_prio->pick(g.st[SD_O_PRIO]);
    put_str(o_orderpriority, r, 16, g.d_o_prio->text[pi].data(),
            (int)g.d_o_prio->text[pi].size());
    i64 clk = g.st[SD_O_CLRK].uniform(1, clerk_max);
    snprintf(buf, sizeof(buf), "Clerk#%09lld", clk);
    put_str(o_clerk, r, 16, buf, (int)strlen(buf));
    int oclen = g.text(buf, (int)(49 * 0.4), (int)(49 * 1.6), g.st[SD_O_CMNT]);
    put_str(o_comment, r, 80, buf, oclen);
    o_shippriority[r] = 0;

    i64 lines = g.st[SD_O_LCNT].uniform(1, 7);
    i64 totalprice = 0;
    int ocnt = 0;
    for (i64 l = 0; l < lines; l++, lrow++) {
      l_orderkey[lrow] = okey;
      l_linenumber[lrow] = l + 1;
      i64 qty = g.st[SD_L_QTY].uniform(1, 50);
      i64 disc = g.st[SD_L_DCNT].uniform(0, 10);
      i64 tax = g.st[SD_L_TAX].uniform(0, 8);
      int si = g.d_instruct->pick(g.st[SD_L_SHIP]);
      put_str(l_shipinstruct, lrow, 26, g.d_instruct->text[si].data(),
              (int)g.d_instruct->text[si].size());
      int mi = g.d_smode->pick(g.st[SD_L_SMODE]);
      put_str(l_shipmode, lrow, 12, g.d_smode->text[mi].data(),
              (int)g.d_smode->text[mi].size());
      int lclen =
          g.text(buf, (int)(27 * 0.4), (int)(27 * 1.6), g.st[SD_L_CMNT]);
      put_str(l_comment, lrow, 44, buf, lclen);
      i64 pkey = g.st[SD_L_PKEY].uniform(1, pkey_max);
      l_partkey[lrow] = pkey;
      i64 rprice = retail_price(pkey);
      i64 snum = g.st[SD_L_SKEY].uniform(0, 3);
      l_suppkey[lrow] = part_supp_bridge(pkey, snum, tot_scnt);
      qty *= 100;  // cents scale
      i64 eprice = rprice * qty / 100;
      l_quantity[lrow] = qty;
      l_extendedprice[lrow] = eprice;
      l_discount[lrow] = disc;
      l_tax[lrow] = tax;
      totalprice += ((eprice * (100 - disc)) / 100) * (100 + tax) / 100;

      i64 s_date = g.st[SD_L_SDTE].uniform(1, 121) + tmp_date;
      i64 c_date = g.st[SD_L_CDTE].uniform(30, 90) + tmp_date;
      i64 r_date = g.st[SD_L_RDTE].uniform(1, 30) + s_date;
      l_shipdate[lrow] = (int32_t)(s_date - kStartDate + kEpochBase);
      l_commitdate[lrow] = (int32_t)(c_date - kStartDate + kEpochBase);
      l_receiptdate[lrow] = (int32_t)(r_date - kStartDate + kEpochBase);
      if (to_julian(r_date) <= kCurrentDate) {
        int fi = g.d_rflag->pick(g.st[SD_L_RFLG]);
        l_returnflag[lrow] = (uint8_t)g.d_rflag->text[fi][0];
      } else {
        l_returnflag[lrow] = 'N';
      }
      if (to_julian(s_date) <= kCurrentDate) {
        ocnt++;
        l_linestatus[lrow] = 'F';
      } else {
        l_linestatus[lrow] = 'O';
      }
    }
    o_totalprice[r] = totalprice;
    uint8_t status = 'O';
    if (ocnt > 0) status = 'P';
    if (ocnt == lines) status = 'F';
    o_orderstatus[r] = status;

    for (int id : oids) g.st[id].finish_row();
    for (int id : lids) g.st[id].finish_row();
  }
  return lrow;
}

}  // extern "C"
