/* Headless oracle driver around the reference's own integrator core.
 *
 * This container has no GL/X11 dev packages, so the reference app
 * (COLLADA -> GLScene -> Application) cannot build.  Instead this driver
 * links the UNMODIFIED pt31-core sources (bvh/bbox/triangle/sphere/light/
 * bsdf/camera/pathtracer/bidirection — the files the reference also ships
 * prebuilt as libs/libpt31.*, CMakeLists.txt:199-218) plus pd_dump
 * instrumentation, and feeds them a scene exported by
 * bidirectional_pathtracing.scene.dump (world-space polygon soup +
 * materials + lights + camera), reproducing the Application::load camera
 * placement (application.cpp:228-304).
 *
 * Usage:
 *   oracle scene.txt W H SPP DEPTH OUT_PREFIX [--pixels id,id,...]
 *          [--integrator pt] [-l N] [--envmap raw.bin]
 *
 * --integrator pt runs the unidirectional PathTracer (N samples per area
 * light) instead of BDPT; --envmap loads a raw f32 equirect HDR
 * (int32 w,h + f32[h*w*3]) as an EnvironmentLight appended to the scene's
 * lights (the reference's -e mechanism, raytraced_renderer.cpp:117-119).
 *
 * Outputs:
 *   OUT_PREFIX.bin            BDPT: int32 w,h + eye,light f32[h*w*3]
 *                             PT:   int32 w,h + combined f32[h*w*3]
 *   OUT_PREFIX_<id>.txt       PD path dumps for each requested flat pixel
 *
 * Determinism: the reference's RNG is an UNSEEDED static mersenne engine
 * per translation unit (src/util/random_util.h:10-14); single-threaded
 * row-major rendering therefore produces the identical stream on every
 * run — outputs are byte-for-byte reproducible.
 */

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

#include "CGL/vector3D.h"
#include "pathtracer/bidirection.h"
#include "pathtracer/bsdf.h"
#include "pathtracer/camera.h"
#include "pathtracer/pd_dump.h"
#include "scene/bvh.h"
#include "scene/light.h"
#include "scene/object.h"
#include "scene/scene.h"
#include "util/halfEdgeMesh.h"

using namespace CGL;
using namespace CGL::SceneObjects;
using std::string;
using std::vector;

static Vector3D rd3(std::istringstream& is) {
    double x, y, z;
    is >> x >> y >> z;
    return Vector3D(x, y, z);
}

int main(int argc, char** argv) {
    if (argc < 7) {
        fprintf(stderr, "usage: %s scene.txt W H SPP DEPTH OUT_PREFIX"
                        " [--pixels id,id,...]\n", argv[0]);
        return 1;
    }
    string scene_path = argv[1];
    size_t w = atoi(argv[2]), h = atoi(argv[3]);
    int spp = atoi(argv[4]), depth = atoi(argv[5]);
    string out_prefix = argv[6];
    vector<long> pixels;
    bool use_pt = false;
    int ns_area_light = 1;
    string envmap_path;
    for (int i = 7; i < argc; i++) {
        if (!strcmp(argv[i], "--pixels") && i + 1 < argc) {
            std::istringstream is(argv[++i]);
            string tok;
            while (std::getline(is, tok, ','))
                pixels.push_back(atol(tok.c_str()));
        } else if (!strcmp(argv[i], "--integrator") && i + 1 < argc) {
            use_pt = !strcmp(argv[++i], "pt");
        } else if (!strcmp(argv[i], "-l") && i + 1 < argc) {
            ns_area_light = atoi(argv[++i]);
        } else if (!strcmp(argv[i], "--envmap") && i + 1 < argc) {
            envmap_path = argv[++i];
        }
    }

    // ---- parse the scene text (scene/dump.py format) ----
    std::ifstream f(scene_path);
    if (!f) { fprintf(stderr, "cannot open %s\n", scene_path.c_str()); return 1; }
    vector<BSDF*> bsdfs;
    vector<SceneObject*> objects;
    vector<SceneLight*> lights;
    double hFov = 50, vFov = 35, nClip = 0.1, fClip = 100;
    Vector3D cam_dir(0, 0, -1);
    Vector3D blo(1e30, 1e30, 1e30), bhi(-1e30, -1e30, -1e30);
    auto expand = [&](const Vector3D& p) {
        blo.x = std::min(blo.x, p.x); blo.y = std::min(blo.y, p.y);
        blo.z = std::min(blo.z, p.z);
        bhi.x = std::max(bhi.x, p.x); bhi.y = std::max(bhi.y, p.y);
        bhi.z = std::max(bhi.z, p.z);
    };
    string line;
    while (std::getline(f, line)) {
        std::istringstream is(line);
        string kind;
        is >> kind;
        if (kind == "camera") {
            is >> hFov >> vFov >> nClip >> fClip;
            cam_dir = rd3(is);
        } else if (kind == "material") {
            string mk; is >> mk;
            if (mk == "diffuse") bsdfs.push_back(new DiffuseBSDF(rd3(is)));
            else if (mk == "emission")
                bsdfs.push_back(new EmissionBSDF(rd3(is)));
            else if (mk == "mirror")
                bsdfs.push_back(new MirrorBSDF(rd3(is)));
            else if (mk == "refraction") {
                Vector3D t = rd3(is); double ior; is >> ior;
                bsdfs.push_back(new RefractionBSDF(t, 0., ior));
            } else if (mk == "glass") {
                Vector3D t = rd3(is), r = rd3(is); double ior; is >> ior;
                bsdfs.push_back(new GlassBSDF(t, r, 0., ior));
            } else if (mk == "microfacet") {
                Vector3D eta = rd3(is), k = rd3(is); double a; is >> a;
                bsdfs.push_back(new MicrofacetBSDF(eta, k, a));
            } else { fprintf(stderr, "bad material %s\n", mk.c_str()); return 1; }
        } else if (kind == "light") {
            string lk; is >> lk;
            if (lk == "area") {
                Vector3D rad = rd3(is), pos = rd3(is), dir = rd3(is);
                Vector3D dx = rd3(is), dy = rd3(is);
                lights.push_back(new AreaLight(rad, pos, dir, dx, dy));
            } else if (lk == "point") {
                Vector3D rad = rd3(is), pos = rd3(is);
                lights.push_back(new PointLight(rad, pos));
            } else { fprintf(stderr, "bad light %s\n", lk.c_str()); return 1; }
        } else if (kind == "sphere") {
            int mid; is >> mid;
            Vector3D c = rd3(is); double r; is >> r;
            SphereObject* so = new SphereObject(c, r, bsdfs[mid]);
            objects.push_back(so);
            expand(c - Vector3D(r, r, r));
            expand(c + Vector3D(r, r, r));
        } else if (kind == "mesh") {
            int mid; size_t nv, np;
            is >> mid >> nv >> np;
            vector<Vector3D> verts(nv);
            for (size_t i = 0; i < nv; i++) {
                std::getline(f, line);
                std::istringstream vs(line);
                verts[i] = rd3(vs);
                expand(verts[i]);
            }
            vector<vector<Index> > polys(np);
            for (size_t i = 0; i < np; i++) {
                std::getline(f, line);
                std::istringstream ps(line);
                size_t k; ps >> k;
                polys[i].resize(k);
                for (size_t j = 0; j < k; j++) ps >> polys[i][j];
            }
            HalfedgeMesh hm;
            hm.build(polys, verts, vector<Vector2D>());
            objects.push_back(new Mesh(hm, bsdfs[mid]));
        }
    }

    // ---- camera placement (application.cpp:228-304 semantics) ----
    Collada::CameraInfo ci;
    ci.hFov = hFov; ci.vFov = vFov; ci.nClip = nClip; ci.fClip = fClip;
    Camera camera;
    camera.configure(ci, 800, 600);   // default window, then resize
    Vector3D target = (blo + bhi) * 0.5;
    double canonical = (bhi - blo).norm() / 2 * 1.5;
    double view_d = canonical * 2, min_r = canonical / 10,
           max_r = canonical * 20;
    double phi = acos(std::min(1.0, std::max(-1.0, cam_dir.y)));
    double theta = atan2(cam_dir.x, cam_dir.z);
    camera.place(target, phi, theta, view_d, min_r, max_r);
    camera.set_screen_size(w, h);
    camera.lensRadius = 0.;
    camera.focalDistance = 4.7;

    // ---- static scene + BVH + tracer ----
    Scene* scene = new Scene(objects, lights);
    vector<Primitive*> prims;
    for (auto* obj : objects) {
        const vector<Primitive*>& p = obj->get_primitives();
        prims.insert(prims.end(), p.begin(), p.end());
    }
    BVHAccel* bvh = new BVHAccel(prims);

    BidirectionalPathTracer* bpt = use_pt ? NULL
                                          : new BidirectionalPathTracer();
    PathTracer* pt = use_pt ? new PathTracer() : bpt;
    pt->ns_aa = spp;
    pt->max_ray_depth = depth;
    pt->ns_area_light = ns_area_light;
    pt->samplesPerBatch = spp;     // adaptive sampling effectively off
    pt->maxTolerance = 0.0;
    pt->direct_hemisphere_sample = false;
    pt->envLight = NULL;
    if (!envmap_path.empty()) {
        FILE* ef = fopen(envmap_path.c_str(), "rb");
        if (!ef) { fprintf(stderr, "no envmap %s\n", envmap_path.c_str());
                   return 1; }
        int32_t ewh[2];
        if (fread(ewh, 4, 2, ef) != 2) return 1;
        HDRImageBuffer* env = new HDRImageBuffer();
        env->resize(ewh[0], ewh[1]);
        for (long i = 0; i < (long)ewh[0] * ewh[1]; i++) {
            float px[3];
            if (fread(px, 4, 3, ef) != 3) return 1;
            env->data[i] = Vector3D(px[0], px[1], px[2]);
        }
        fclose(ef);
        pt->envLight = new EnvironmentLight(env);
        scene->lights.push_back(pt->envLight);
    }
    pt->scene = scene;
    pt->camera = &camera;
    pt->bvh = bvh;
    pt->set_frame_size(w, h);

    string dir = ".", tag = out_prefix;
    size_t slash = out_prefix.rfind('/');
    if (slash != string::npos) {
        dir = out_prefix.substr(0, slash);
        tag = out_prefix.substr(slash + 1);
    }
    pd::configure(dir, tag, (long)w, pixels);

    fprintf(stderr, "[oracle] %zu objects, %zu lights, %zu prims; "
            "%zux%zu spp=%d depth=%d\n", objects.size(), lights.size(),
            prims.size(), w, h, spp, depth);
    for (size_t y = 0; y < h; y++)
        for (size_t x = 0; x < w; x++)
            pt->raytrace_pixel(x, y);
    pd::finish();

    // ---- raw buffer dump: int32 w,h then buffers f32[h*w*3] ----
    string bin = out_prefix + ".bin";
    FILE* bf = fopen(bin.c_str(), "wb");
    int32_t wh[2] = {(int32_t)w, (int32_t)h};
    fwrite(wh, 4, 2, bf);
    vector<HDRImageBuffer*> bufs;
    vector<double> scale;
    if (use_pt) {
        // PathTracer::raytrace_pixel stores the per-pixel mean
        // (pathtracer.cpp:334-336)
        bufs.push_back(&pt->sampleBuffer);
        scale.push_back(1.0);
    } else {
        bufs.push_back(&bpt->eyeBuffer);
        bufs.push_back(&bpt->lightBuffer);
        scale.push_back(1.0);
        scale.push_back(1.0);
    }
    for (size_t b = 0; b < bufs.size(); b++)
        for (size_t y = 0; y < h; y++)
            for (size_t x = 0; x < w; x++) {
                Vector3D v = bufs[b]->get_pixel(x, y) * scale[b];
                float px[3] = {(float)v.x, (float)v.y, (float)v.z};
                fwrite(px, 4, 3, bf);
            }
    fclose(bf);
    fprintf(stderr, "[oracle] wrote %s\n", bin.c_str());
    return 0;
}
