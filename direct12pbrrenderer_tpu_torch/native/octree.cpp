// Loose octree with frustum culling — native rebuild of
// Engine/Include/Utils/LooseOctree.h: loose factor 1.5x, max depth 8, nodes
// split past 2 elements, elements remember their node for O(1) updates.
//
// The device render path culls with a vectorized all-boxes test (mathlib /
// scene_pack); this tree is the host-side equivalent for editor-style
// workloads (many small incremental updates, few queries) and for parity
// with the reference's CPU culling. C ABI for ctypes (utils/octree.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr float LOOSE = 1.5f;
constexpr int MAX_DEPTH = 8;
constexpr int SPLIT_THRESHOLD = 2;

struct AABB {
    float mn[3], mx[3];
    bool contains(const AABB& o) const {
        for (int i = 0; i < 3; ++i)
            if (o.mn[i] < mn[i] || o.mx[i] > mx[i]) return false;
        return true;
    }
};

struct Node {
    AABB bound;        // tight bound; the loose bound scales extents by 1.5
    int32_t children = -1;  // index of first of 8 children, -1 = leaf
    int32_t depth = 0;
    std::vector<int32_t> elements;
};

struct Element {
    AABB box;
    int32_t node = -1;
    bool alive = false;
};

struct Octree {
    std::vector<Node> nodes;
    std::vector<Element> elems;
    std::vector<int32_t> free_elems;

    explicit Octree(const float* mn, const float* mx) {
        Node root;
        std::memcpy(root.bound.mn, mn, 12);
        std::memcpy(root.bound.mx, mx, 12);
        nodes.push_back(root);
    }

    AABB loose(const AABB& b) const {
        AABB o;
        for (int i = 0; i < 3; ++i) {
            float c = (b.mn[i] + b.mx[i]) * 0.5f;
            float e = (b.mx[i] - b.mn[i]) * 0.5f * LOOSE;
            o.mn[i] = c - e;
            o.mx[i] = c + e;
        }
        return o;
    }

    void split(int32_t ni) {
        Node& n = nodes[ni];
        if (n.children >= 0 || n.depth >= MAX_DEPTH) return;
        int32_t base = (int32_t)nodes.size();
        float cx = (n.bound.mn[0] + n.bound.mx[0]) * 0.5f;
        float cy = (n.bound.mn[1] + n.bound.mx[1]) * 0.5f;
        float cz = (n.bound.mn[2] + n.bound.mx[2]) * 0.5f;
        for (int i = 0; i < 8; ++i) {
            Node c;
            c.depth = nodes[ni].depth + 1;
            const AABB& b = nodes[ni].bound;
            c.bound.mn[0] = (i & 1) ? cx : b.mn[0];
            c.bound.mx[0] = (i & 1) ? b.mx[0] : cx;
            c.bound.mn[1] = (i & 2) ? cy : b.mn[1];
            c.bound.mx[1] = (i & 2) ? b.mx[1] : cy;
            c.bound.mn[2] = (i & 4) ? cz : b.mn[2];
            c.bound.mx[2] = (i & 4) ? b.mx[2] : cz;
            nodes.push_back(c);
        }
        nodes[ni].children = base;
        // re-distribute elements that fit a child's loose bound
        auto elems_copy = nodes[ni].elements;
        nodes[ni].elements.clear();
        for (int32_t e : elems_copy) place(ni, e);
    }

    void place(int32_t ni, int32_t ei) {
        // descend while a child's loose bound contains the element
        for (;;) {
            Node& n = nodes[ni];
            if (n.children < 0) break;
            int next = -1;
            for (int i = 0; i < 8; ++i) {
                if (loose(nodes[n.children + i].bound).contains(elems[ei].box)) {
                    next = n.children + i;
                    break;
                }
            }
            if (next < 0) break;
            ni = next;
        }
        nodes[ni].elements.push_back(ei);
        elems[ei].node = ni;
        if (nodes[ni].children < 0 && nodes[ni].depth < MAX_DEPTH
            && (int)nodes[ni].elements.size() > SPLIT_THRESHOLD)
            split(ni);
    }

    int32_t add(const float* mn, const float* mx) {
        int32_t ei;
        if (!free_elems.empty()) {
            ei = free_elems.back();
            free_elems.pop_back();
        } else {
            ei = (int32_t)elems.size();
            elems.emplace_back();
        }
        std::memcpy(elems[ei].box.mn, mn, 12);
        std::memcpy(elems[ei].box.mx, mx, 12);
        elems[ei].alive = true;
        place(0, ei);
        return ei;
    }

    void update(int32_t ei, const float* mn, const float* mx) {
        remove_from_node(ei);
        std::memcpy(elems[ei].box.mn, mn, 12);
        std::memcpy(elems[ei].box.mx, mx, 12);
        place(0, ei);
    }

    void remove_from_node(int32_t ei) {
        int32_t ni = elems[ei].node;
        if (ni < 0) return;
        auto& v = nodes[ni].elements;
        for (size_t i = 0; i < v.size(); ++i)
            if (v[i] == ei) {
                v[i] = v.back();
                v.pop_back();
                break;
            }
        elems[ei].node = -1;
    }

    void remove(int32_t ei) {
        remove_from_node(ei);
        elems[ei].alive = false;
        free_elems.push_back(ei);
    }

    // planes: 6x4 (a,b,c,d), inside when dot(n,p)+d >= 0
    static int box_vs_frustum(const AABB& b, const float* planes) {
        for (int p = 0; p < 6; ++p) {
            const float* pl = planes + p * 4;
            float d = pl[3];
            for (int i = 0; i < 3; ++i)
                d += pl[i] * (pl[i] > 0 ? b.mx[i] : b.mn[i]);
            if (d < 0) return 0;
        }
        return 1;
    }

    int cull(const float* planes, int32_t* out, int max_out) const {
        int count = 0;
        std::vector<int32_t> stack{0};
        while (!stack.empty()) {
            int32_t ni = stack.back();
            stack.pop_back();
            const Node& n = nodes[ni];
            AABB lb = loose(n.bound);
            if (!box_vs_frustum(lb, planes)) continue;
            for (int32_t e : n.elements)
                if (elems[e].alive && box_vs_frustum(elems[e].box, planes)) {
                    if (count < max_out) out[count] = e;
                    ++count;
                }
            if (n.children >= 0)
                for (int i = 0; i < 8; ++i) stack.push_back(n.children + i);
        }
        return count;
    }
};

} // namespace

extern "C" {

void* octree_create(const float* mn, const float* mx) { return new Octree(mn, mx); }
void octree_destroy(void* t) { delete (Octree*)t; }
int32_t octree_add(void* t, const float* mn, const float* mx) {
    return ((Octree*)t)->add(mn, mx);
}
void octree_update(void* t, int32_t ei, const float* mn, const float* mx) {
    ((Octree*)t)->update(ei, mn, mx);
}
void octree_remove(void* t, int32_t ei) { ((Octree*)t)->remove(ei); }
int octree_cull(void* t, const float* planes, int32_t* out, int max_out) {
    return ((Octree*)t)->cull(planes, out, max_out);
}
int octree_node_count(void* t) { return (int)((Octree*)t)->nodes.size(); }

} // extern "C"
