// Native quality triangulator: constrained Delaunay + Ruppert refinement.
//
// TPU-framework replacement for the reference's dependency on Shewchuk's
// Triangle (called with flags "pa<area>Qq" at mesh.jl:312-317): triangulate a
// polygon (possibly non-convex, e.g. the L-shape and slit geometries), enforce
// its boundary segments, and refine until every triangle respects the maximum
// area and a ~20° minimum-angle quality bound.  Bowyer-Watson incremental
// Delaunay with midpoint segment recovery and circumcenter (Ruppert) point
// insertion; encroached boundary segments are split instead.
//
// Exposed C ABI (ctypes): mioc_triangulate(...) — see _native_triangle.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <set>
#include <utility>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

struct Tri {
  int v[3];
  bool alive = true;
};

struct Seg {
  int a, b;     // endpoint point indices
  int marker;   // original polygon side (1-based)
};

static double orient(const Pt& a, const Pt& b, const Pt& c) {
  return (b.x - a.x) * (c.y - a.y) - (b.y - a.y) * (c.x - a.x);
}

static bool in_circumcircle(const Pt& a, const Pt& b, const Pt& c, const Pt& p) {
  // Assumes (a, b, c) counterclockwise.
  double ax = a.x - p.x, ay = a.y - p.y;
  double bx = b.x - p.x, by = b.y - p.y;
  double cx = c.x - p.x, cy = c.y - p.y;
  double det = (ax * ax + ay * ay) * (bx * cy - cx * by) -
               (bx * bx + by * by) * (ax * cy - cx * ay) +
               (cx * cx + cy * cy) * (ax * by - bx * ay);
  return det > 1e-14;
}

struct Delaunay {
  std::vector<Pt> pts;
  std::vector<Tri> tris;

  void init_super(double xmin, double ymin, double xmax, double ymax) {
    double dx = xmax - xmin, dy = ymax - ymin;
    double d = std::max(dx, dy) * 20.0 + 1.0;
    double cx = (xmin + xmax) / 2.0, cy = (ymin + ymax) / 2.0;
    pts.push_back({cx - d, cy - d});
    pts.push_back({cx + d, cy - d});
    pts.push_back({cx, cy + d});
    tris.push_back({{0, 1, 2}});
  }

  // Bowyer-Watson insertion. Returns the index of the inserted point.
  int insert(const Pt& p) {
    int pi = (int)pts.size();
    pts.push_back(p);

    // Cavity: all triangles whose circumcircle contains p.
    std::vector<int> bad;
    for (int t = 0; t < (int)tris.size(); ++t) {
      if (!tris[t].alive) continue;
      const Tri& T = tris[t];
      Pt a = pts[T.v[0]], b = pts[T.v[1]], c = pts[T.v[2]];
      if (orient(a, b, c) < 0) std::swap(b, c);
      if (in_circumcircle(a, b, c, p)) bad.push_back(t);
    }
    // Boundary of the cavity: edges appearing exactly once.
    std::map<std::pair<int, int>, std::pair<int, int>> edges;  // sorted -> oriented
    for (int t : bad) {
      const Tri& T = tris[t];
      for (int e = 0; e < 3; ++e) {
        int u = T.v[e], v = T.v[(e + 1) % 3];
        auto key = std::minmax(u, v);
        auto it = edges.find(key);
        if (it == edges.end())
          edges[key] = {u, v};
        else
          edges.erase(it);
      }
      tris[t].alive = false;
    }
    for (auto& [key, uv] : edges) {
      int u = uv.first, v = uv.second;
      // Orient counterclockwise around p.
      if (orient(pts[u], pts[v], p) < 0) std::swap(u, v);
      tris.push_back({{u, v, pi}});
    }
    return pi;
  }

  void compact() {
    std::vector<Tri> out;
    for (auto& t : tris)
      if (t.alive) out.push_back(t);
    tris.swap(out);
  }
};

static bool edge_exists(const Delaunay& D, int a, int b) {
  for (const auto& t : D.tris) {
    if (!t.alive) continue;
    for (int e = 0; e < 3; ++e) {
      int u = t.v[e], v = t.v[(e + 1) % 3];
      if ((u == a && v == b) || (u == b && v == a)) return true;
    }
  }
  return false;
}

static bool point_in_polygon(const std::vector<Pt>& poly, double x, double y) {
  bool inside = false;
  int n = (int)poly.size();
  for (int i = 0; i < n; ++i) {
    const Pt& p1 = poly[i];
    const Pt& p2 = poly[(i + 1) % n];
    if ((p1.y > y) != (p2.y > y)) {
      double xin = (p2.x - p1.x) * (y - p1.y) / (p2.y - p1.y) + p1.x;
      if (x < xin) inside = !inside;
    }
  }
  return inside;
}

struct Mesher {
  Delaunay D;
  std::vector<Pt> poly;
  std::vector<Seg> segs;  // current boundary sub-segments
  double maxarea;
  double min_angle_deg = 20.0;

  double tri_area(const Tri& t) const {
    return std::fabs(orient(D.pts[t.v[0]], D.pts[t.v[1]], D.pts[t.v[2]])) / 2.0;
  }

  double min_angle(const Tri& t) const {
    double best = 1e9;
    for (int e = 0; e < 3; ++e) {
      const Pt& a = D.pts[t.v[e]];
      const Pt& b = D.pts[t.v[(e + 1) % 3]];
      const Pt& c = D.pts[t.v[(e + 2) % 3]];
      double ux = b.x - a.x, uy = b.y - a.y;
      double vx = c.x - a.x, vy = c.y - a.y;
      double nu = std::hypot(ux, uy), nv = std::hypot(vx, vy);
      if (nu < 1e-300 || nv < 1e-300) return 0.0;
      double cosang = std::clamp((ux * vx + uy * vy) / (nu * nv), -1.0, 1.0);
      best = std::min(best, std::acos(cosang));
    }
    return best * 180.0 / M_PI;
  }

  Pt circumcenter(const Tri& t) const {
    const Pt& a = D.pts[t.v[0]];
    const Pt& b = D.pts[t.v[1]];
    const Pt& c = D.pts[t.v[2]];
    double d = 2.0 * orient(a, b, c);
    double a2 = a.x * a.x + a.y * a.y;
    double b2 = b.x * b.x + b.y * b.y;
    double c2 = c.x * c.x + c.y * c.y;
    return {(a2 * (b.y - c.y) + b2 * (c.y - a.y) + c2 * (a.y - b.y)) / d,
            (a2 * (c.x - b.x) + b2 * (a.x - c.x) + c2 * (b.x - a.x)) / d};
  }

  // Does p encroach segment s (lie in its diametral circle)?
  bool encroaches(const Seg& s, const Pt& p) const {
    const Pt& a = D.pts[s.a];
    const Pt& b = D.pts[s.b];
    double mx = (a.x + b.x) / 2.0, my = (a.y + b.y) / 2.0;
    double r2 = ((a.x - b.x) * (a.x - b.x) + (a.y - b.y) * (a.y - b.y)) / 4.0;
    double d2 = (p.x - mx) * (p.x - mx) + (p.y - my) * (p.y - my);
    return d2 < r2 * (1.0 - 1e-12);
  }

  void split_segment(int si) {
    Seg s = segs[si];
    Pt mid{(D.pts[s.a].x + D.pts[s.b].x) / 2.0,
           (D.pts[s.a].y + D.pts[s.b].y) / 2.0};
    int m = D.insert(mid);
    segs[si] = {s.a, m, s.marker};
    segs.push_back({m, s.b, s.marker});
  }

  void recover_segments() {
    // Split segments until every sub-segment is a Delaunay edge.
    bool changed = true;
    int guard = 0;
    while (changed && guard++ < 10000) {
      changed = false;
      for (int i = 0; i < (int)segs.size(); ++i) {
        if (!edge_exists(D, segs[i].a, segs[i].b)) {
          split_segment(i);
          changed = true;
          break;
        }
      }
    }
  }

  bool inside_domain(const Tri& t) const {
    double cx = (D.pts[t.v[0]].x + D.pts[t.v[1]].x + D.pts[t.v[2]].x) / 3.0;
    double cy = (D.pts[t.v[0]].y + D.pts[t.v[1]].y + D.pts[t.v[2]].y) / 3.0;
    return point_in_polygon(poly, cx, cy);
  }

  bool uses_super(const Tri& t) const {
    return t.v[0] < 3 || t.v[1] < 3 || t.v[2] < 3;
  }

  bool is_bad(const Tri& t) const {
    if (!t.alive || uses_super(t) || !inside_domain(t)) return false;
    if (tri_area(t) > maxarea) return true;
    if (min_angle(t) < min_angle_deg) return true;
    return false;
  }

  void refine() {
    int guard = 0;
    const int max_inserts = 200000;
    while (guard++ < max_inserts) {
      // Split any encroached segment first (Ruppert rule 1).
      int enc = -1;
      for (int i = 0; i < (int)segs.size() && enc < 0; ++i) {
        for (int pi = 3; pi < (int)D.pts.size(); ++pi) {
          if (pi == segs[i].a || pi == segs[i].b) continue;
          if (encroaches(segs[i], D.pts[pi])) {
            enc = i;
            break;
          }
        }
      }
      if (enc >= 0) {
        split_segment(enc);
        continue;
      }
      // Then fix the worst bad triangle (Ruppert rule 2).
      int bad = -1;
      double worst = 0.0;
      for (int t = 0; t < (int)D.tris.size(); ++t) {
        if (!is_bad(D.tris[t])) continue;
        double score = tri_area(D.tris[t]) / maxarea +
                       std::max(0.0, min_angle_deg - min_angle(D.tris[t]));
        if (score > worst) {
          worst = score;
          bad = t;
        }
      }
      if (bad < 0) break;
      Pt cc = circumcenter(D.tris[bad]);
      // If the circumcenter encroaches a segment, split that segment instead.
      int enc2 = -1;
      for (int i = 0; i < (int)segs.size(); ++i) {
        if (encroaches(segs[i], cc)) {
          enc2 = i;
          break;
        }
      }
      if (enc2 >= 0) {
        split_segment(enc2);
      } else if (point_in_polygon(poly, cc.x, cc.y)) {
        D.insert(cc);
      } else {
        // Off-domain circumcenter with no encroachment: split the triangle's
        // longest edge midpoint as a fallback.
        const Tri& t = D.tris[bad];
        int ea = t.v[0], eb = t.v[1];
        double best = -1.0;
        for (int e = 0; e < 3; ++e) {
          int u = t.v[e], v = t.v[(e + 1) % 3];
          double len = std::hypot(D.pts[u].x - D.pts[v].x,
                                  D.pts[u].y - D.pts[v].y);
          if (len > best) {
            best = len;
            ea = u;
            eb = v;
          }
        }
        D.insert({(D.pts[ea].x + D.pts[eb].x) / 2.0,
                  (D.pts[ea].y + D.pts[eb].y) / 2.0});
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns packed counts: npts | ntri << 20 | nseg << 40 (or <= 0 on failure).
long long mioc_triangulate(const double* polygon, int nverts, double maxarea,
                           double* out_pts, int cap_pts, int* out_tris,
                           int cap_tris, int* out_segs, int cap_segs) {
  if (nverts < 3 || maxarea <= 0) return -1;
  Mesher M;
  M.maxarea = maxarea;
  double xmin = 1e300, ymin = 1e300, xmax = -1e300, ymax = -1e300;
  for (int i = 0; i < nverts; ++i) {
    Pt p{polygon[2 * i], polygon[2 * i + 1]};
    M.poly.push_back(p);
    xmin = std::min(xmin, p.x);
    xmax = std::max(xmax, p.x);
    ymin = std::min(ymin, p.y);
    ymax = std::max(ymax, p.y);
  }
  M.D.init_super(xmin, ymin, xmax, ymax);
  std::vector<int> vidx(nverts);
  for (int i = 0; i < nverts; ++i) vidx[i] = M.D.insert(M.poly[i]);
  for (int i = 0; i < nverts; ++i)
    M.segs.push_back({vidx[i], vidx[(i + 1) % nverts], i + 1});

  M.recover_segments();
  M.refine();
  M.D.compact();

  // Collect interior triangles and remap point indices (drop super vertices
  // and any unused points).
  std::vector<int> remap(M.D.pts.size(), -1);
  std::vector<int> keep_tris;
  for (int t = 0; t < (int)M.D.tris.size(); ++t) {
    const Tri& T = M.D.tris[t];
    if (!T.alive || M.uses_super(T) || !M.inside_domain(T)) continue;
    if (M.tri_area(T) < 1e-14) continue;
    keep_tris.push_back(t);
    for (int e = 0; e < 3; ++e) remap[T.v[e]] = 0;
  }
  // Boundary segment endpoints must survive too.
  for (const Seg& s : M.segs) {
    if (remap[s.a] == 0 || remap[s.b] == 0) {
      remap[s.a] = std::max(remap[s.a], 0);
      remap[s.b] = std::max(remap[s.b], 0);
    }
  }
  int npts = 0;
  for (int i = 0; i < (int)remap.size(); ++i)
    if (remap[i] == 0) remap[i] = npts++;
  int ntri = (int)keep_tris.size();
  int nseg = 0;
  for (const Seg& s : M.segs)
    if (remap[s.a] >= 0 && remap[s.b] >= 0) ++nseg;
  if (npts > cap_pts || ntri > cap_tris || nseg > cap_segs) return -2;

  for (int i = 0; i < (int)remap.size(); ++i) {
    if (remap[i] >= 0) {
      out_pts[2 * remap[i]] = M.D.pts[i].x;
      out_pts[2 * remap[i] + 1] = M.D.pts[i].y;
    }
  }
  for (int k = 0; k < ntri; ++k) {
    const Tri& T = M.D.tris[keep_tris[k]];
    int a = remap[T.v[0]], b = remap[T.v[1]], c = remap[T.v[2]];
    // Counterclockwise orientation.
    if (orient({out_pts[2 * a], out_pts[2 * a + 1]},
               {out_pts[2 * b], out_pts[2 * b + 1]},
               {out_pts[2 * c], out_pts[2 * c + 1]}) < 0)
      std::swap(b, c);
    out_tris[3 * k] = a;
    out_tris[3 * k + 1] = b;
    out_tris[3 * k + 2] = c;
  }
  int si = 0;
  for (const Seg& s : M.segs) {
    if (remap[s.a] < 0 || remap[s.b] < 0) continue;
    out_segs[3 * si] = remap[s.a];
    out_segs[3 * si + 1] = remap[s.b];
    out_segs[3 * si + 2] = s.marker;
    ++si;
  }
  return (long long)npts | ((long long)ntri << 20) | ((long long)nseg << 40);
}

}  // extern "C"
