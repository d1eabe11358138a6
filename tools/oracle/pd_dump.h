/* Path-dump instrumentation installed into the COPIED reference tree as
 * src/pathtracer/pd_dump.h (see instrument.py).  This is the repo's
 * equivalent of the reference's prebuilt pt31 oracle mechanism
 * (reference CMakeLists.txt:199-218): an instrumented build of the
 * author's own integrator whose output the JAX port is validated against.
 *
 * Emits, for selected pixels of a -s 1 single-threaded render:
 *   PD EYE|LIGHT k  pos xyz  n xyz  alpha xyz  p P  dirpdf D  alb A  delta B  mat M
 *   PD LS|ES  i j   pos xyz  n xyz  alpha xyz  p P  dirpdf D
 *   PD EST  i j  c xyz  contrib xyz  w W  ill xyz  xy X Y
 *   PD COMBO i j  ill xyz
 * consumed by tests/test_bdpt_paths.py.  Material ids are the object's
 * index in scene->objects order (the dump-order convention the test's
 * _dump_material_map re-derives).
 */
#ifndef PD_DUMP_H
#define PD_DUMP_H

#include <cstdio>
#include <cstdlib>
#include <map>
#include <set>
#include <string>
#include <vector>

#include "bidirection.h"
#include "scene/object.h"

namespace pd {

struct State {
    std::set<long> pixels;        // flat ids y*width+x to dump
    long width = 0;
    std::string out_dir = ".";
    std::string tag = "pd";
    FILE* f = nullptr;            // active dump file (null = inactive)
    std::map<const CGL::BSDF*, int> mat_ids;
    bool mats_built = false;
};

inline State& st() { static State s; return s; }

inline void configure(const std::string& out_dir, const std::string& tag,
                      long width, const std::vector<long>& pixel_ids) {
    st().out_dir = out_dir;
    st().tag = tag;
    st().width = width;
    st().pixels.insert(pixel_ids.begin(), pixel_ids.end());
}

inline void build_mats(CGL::PathTracer* pt) {
    if (st().mats_built || !pt->scene) return;
    int i = 0;
    for (auto* obj : pt->scene->objects)
        st().mat_ids[obj->get_bsdf()] = i++;
    st().mats_built = true;
}

/* hook: start of BidirectionalPathTracer::raytrace_pixel */
inline void set_pixel(CGL::PathTracer* pt, size_t x, size_t y) {
    State& s = st();
    if (s.f) { fclose(s.f); s.f = nullptr; }
    long flat = (long)y * s.width + (long)x;
    if (!s.pixels.count(flat)) return;
    build_mats(pt);
    std::string path = s.out_dir + "/" + s.tag + "_"
                       + std::to_string(flat) + ".txt";
    s.f = fopen(path.c_str(), "w");
}

inline int mat_of(const CGL::PathVertex& v) {
    if (!v.isect.bsdf) return -1;
    auto it = st().mat_ids.find(v.isect.bsdf);
    return it == st().mat_ids.end() ? -1 : it->second;
}

inline double alb_of(const CGL::PathVertex& v) {
    const CGL::DiffuseBSDF* d =
        dynamic_cast<const CGL::DiffuseBSDF*>(v.isect.bsdf);
    return d ? const_cast<CGL::DiffuseBSDF*>(d)->f(
                   CGL::Vector3D(0, 0, 1), CGL::Vector3D(0, 0, 1)).x * PI
             : -1.0;
}

inline void vprint(FILE* f, const char* k, const CGL::Vector3D& v) {
    fprintf(f, " %s %.9g %.9g %.9g", k, v.x, v.y, v.z);
}

/* hook: after both subpaths are built in est_radiance_global_illumination */
inline void dump_paths(const std::vector<CGL::PathVertex>& eye,
                       const std::vector<CGL::PathVertex>& light) {
    FILE* f = st().f;
    if (!f) return;
    const std::vector<CGL::PathVertex>* paths[2] = {&eye, &light};
    const char* names[2] = {"EYE", "LIGHT"};
    for (int w = 0; w < 2; w++) {
        const auto& p = *paths[w];
        for (size_t k = 1; k < p.size(); k++) {
            const auto& v = p[k];
            fprintf(f, "PD %s %zu", names[w], k);
            vprint(f, "pos", v.position);
            vprint(f, "n", v.isect.n);
            vprint(f, "alpha", v.alpha);
            fprintf(f, " p %.9g dirpdf %.9g", v.p, v.dir_pdf);
            bool surf = k >= 2 && v.isect.bsdf;
            fprintf(f, " alb %.9g delta %d mat %d\n",
                    surf ? alb_of(v) : -1.0,
                    surf ? (int)v.isect.bsdf->is_delta() : 0,
                    surf ? mat_of(v) : -1);
        }
    }
    fflush(f);
}

/* hook: after light_sample / eye_sample construction in
 * estimate_bidirection_radiance */
inline void dump_sample(const char* kind, int i_eye, int i_light,
                        const CGL::PathVertex& v) {
    FILE* f = st().f;
    if (!f) return;
    fprintf(f, "PD %s %d %d", kind, i_eye, i_light);
    vprint(f, "pos", v.position);
    vprint(f, "n", v.isect.n);
    vprint(f, "alpha", v.alpha);
    fprintf(f, " p %.9g dirpdf %.9g\n", v.p, v.dir_pdf);
}

/* hook: before the i_eye==1 splat branch (after ill = contrib * w) */
inline void dump_est(int i_eye, int i_light, const CGL::Vector3D& c,
                     const CGL::Vector3D& contrib, double w,
                     const CGL::Vector3D& ill, int x, int y) {
    FILE* f = st().f;
    if (!f) return;
    fprintf(f, "PD EST %d %d", i_eye, i_light);
    vprint(f, "c", c);
    vprint(f, "contrib", contrib);
    fprintf(f, " w %.9g", w);
    vprint(f, "ill", ill);
    fprintf(f, " xy %d %d\n", x, y);
}

/* hook: per-combo return value in est_radiance_global_illumination */
inline void dump_combo(int i, int j, const CGL::Vector3D& ill) {
    FILE* f = st().f;
    if (!f) return;
    fprintf(f, "PD COMBO %d %d", i, j);
    vprint(f, "ill", ill);
    fprintf(f, "\n");
}

inline void finish() {
    if (st().f) { fclose(st().f); st().f = nullptr; }
}

}  // namespace pd

#endif  // PD_DUMP_H
