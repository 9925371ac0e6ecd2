// Two-Level Segregated Fit allocator — native rebuild of the reference's
// advertised TLSF metadata allocator (Engine/Include/Utils/Allocator.h:626-
// 1102): first/second-level bitmaps, block split/merge on free, alignment-
// aware search. Manages OFFSETS only; the backing memory is external (in the
// reference: a 64MB ID3D12Heap page; here: host staging arenas for asset
// uploads and pinned host buffers feeding jax.device_put).
//
// C ABI for ctypes (utils/tlsf.py).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

constexpr int SL_COUNT_LOG2 = 4;           // 16 second-level subdivisions
constexpr int SL_COUNT = 1 << SL_COUNT_LOG2;
constexpr int FL_MAX = 40;

inline int fls64(uint64_t v) { return v ? 63 - __builtin_clzll(v) : -1; }
inline int ffs64(uint64_t v) { return v ? __builtin_ctzll(v) : -1; }

struct Block {
    uint64_t offset = 0;
    uint64_t size = 0;
    bool free = false;
    int32_t prev_phys = -1;   // physical neighbors (by offset)
    int32_t next_phys = -1;
    int32_t prev_free = -1;   // free-list links
    int32_t next_free = -1;
};

struct TLSF {
    uint64_t min_block;
    uint64_t total;
    uint64_t used = 0;
    int fl_shift;                                 // log2(min_block)
    uint64_t fl_bitmap = 0;
    uint32_t sl_bitmap[FL_MAX] = {};
    int32_t free_lists[FL_MAX][SL_COUNT];
    std::vector<Block> blocks;
    std::vector<int32_t> free_slots;              // recycled Block indices

    explicit TLSF(uint64_t size, uint64_t min_blk) : min_block(min_blk), total(size) {
        fl_shift = fls64(min_blk);
        for (auto& row : free_lists) std::fill(row, row + SL_COUNT, -1);
        int32_t b = new_block();
        blocks[b].offset = 0;
        blocks[b].size = size;
        insert_free(b);
    }

    int32_t new_block() {
        if (!free_slots.empty()) {
            int32_t i = free_slots.back();
            free_slots.pop_back();
            blocks[i] = Block{};
            return i;
        }
        blocks.emplace_back();
        return (int32_t)blocks.size() - 1;
    }

    void mapping(uint64_t size, int& fl, int& sl) const {
        if (size < min_block) size = min_block;
        int msb = fls64(size);
        fl = msb - fl_shift;
        sl = (int)((size >> (msb - SL_COUNT_LOG2)) & (SL_COUNT - 1));
        if (fl >= FL_MAX) { fl = FL_MAX - 1; sl = SL_COUNT - 1; }
    }

    void insert_free(int32_t bi) {
        Block& b = blocks[bi];
        b.free = true;
        int fl, sl;
        mapping(b.size, fl, sl);
        b.prev_free = -1;
        b.next_free = free_lists[fl][sl];
        if (b.next_free >= 0) blocks[b.next_free].prev_free = bi;
        free_lists[fl][sl] = bi;
        fl_bitmap |= 1ull << fl;
        sl_bitmap[fl] |= 1u << sl;
    }

    void remove_free(int32_t bi) {
        Block& b = blocks[bi];
        int fl, sl;
        mapping(b.size, fl, sl);
        if (b.prev_free >= 0) blocks[b.prev_free].next_free = b.next_free;
        else free_lists[fl][sl] = b.next_free;
        if (b.next_free >= 0) blocks[b.next_free].prev_free = b.prev_free;
        if (free_lists[fl][sl] < 0) {
            sl_bitmap[fl] &= ~(1u << sl);
            if (!sl_bitmap[fl]) fl_bitmap &= ~(1ull << fl);
        }
        b.free = false;
        b.prev_free = b.next_free = -1;
    }

    int32_t find_free(uint64_t size) {
        int fl, sl;
        // round up so any block in the found list fits
        uint64_t want = size;
        if (want >= min_block) {
            int msb = fls64(want);
            uint64_t round = (1ull << (msb - SL_COUNT_LOG2)) - 1;
            want += round;
        }
        mapping(want, fl, sl);
        uint32_t sl_map = sl_bitmap[fl] & (~0u << sl);
        if (!sl_map) {
            uint64_t fl_map = fl_bitmap & (~0ull << (fl + 1));
            if (!fl_map) return -1;
            fl = ffs64(fl_map);
            sl_map = sl_bitmap[fl];
        }
        sl = ffs64(sl_map);
        return free_lists[fl][sl];
    }

    int64_t allocate(uint64_t size, uint64_t align) {
        if (size == 0) size = 1;
        size = std::max(size, min_block);
        size = (size + min_block - 1) / min_block * min_block;
        uint64_t search = size + (align > min_block ? align : 0);

        int32_t bi = find_free(search);
        if (bi < 0) return -1;
        remove_free(bi);

        Block& b = blocks[bi];
        uint64_t aligned = align ? (b.offset + align - 1) / align * align : b.offset;
        uint64_t head = aligned - b.offset;
        if (head >= min_block) {
            // split the alignment head into its own free fragment
            int32_t hb = new_block();
            Block& h = blocks[hb];
            Block& bb = blocks[bi];
            h.offset = bb.offset;
            h.size = head;
            h.prev_phys = bb.prev_phys;
            h.next_phys = bi;
            if (bb.prev_phys >= 0) blocks[bb.prev_phys].next_phys = hb;
            bb.prev_phys = hb;
            bb.offset = aligned;
            bb.size -= head;
            insert_free(hb);
        } else if (head > 0) {
            return allocate_retry(size, align, bi);
        }
        Block& bb = blocks[bi];
        if (bb.size >= size + min_block) {
            int32_t tb = new_block();
            Block& t = blocks[tb];
            Block& b2 = blocks[bi];
            t.offset = b2.offset + size;
            t.size = b2.size - size;
            t.prev_phys = bi;
            t.next_phys = b2.next_phys;
            if (b2.next_phys >= 0) blocks[b2.next_phys].prev_phys = tb;
            b2.next_phys = tb;
            b2.size = size;
            insert_free(tb);
        }
        blocks[bi].free = false;
        used += blocks[bi].size;
        return (int64_t)blocks[bi].offset;
    }

    int64_t allocate_retry(uint64_t size, uint64_t align, int32_t bi) {
        // alignment head smaller than min_block: give the block back and
        // retry with padding folded into the request
        insert_free(bi);
        return allocate(size + align, align);
    }

    bool free_at(uint64_t offset) {
        // find the allocated block with this offset (linear in block count of
        // that offset chain is avoided: scan blocks — callers hold few
        // thousand blocks; a hash could be added if it ever shows up)
        for (size_t i = 0; i < blocks.size(); ++i) {
            Block& b = blocks[i];
            if (!b.free && b.size && b.offset == offset
                && std::find(free_slots.begin(), free_slots.end(), (int32_t)i)
                       == free_slots.end()) {
                used -= b.size;
                int32_t cur = (int32_t)i;
                // merge with free physical neighbors
                if (b.prev_phys >= 0 && blocks[b.prev_phys].free) {
                    int32_t p = b.prev_phys;
                    remove_free(p);
                    blocks[p].size += blocks[cur].size;
                    blocks[p].next_phys = blocks[cur].next_phys;
                    if (blocks[cur].next_phys >= 0)
                        blocks[blocks[cur].next_phys].prev_phys = p;
                    free_slots.push_back(cur);
                    cur = p;
                }
                if (blocks[cur].next_phys >= 0 && blocks[blocks[cur].next_phys].free) {
                    int32_t n = blocks[cur].next_phys;
                    remove_free(n);
                    blocks[cur].size += blocks[n].size;
                    blocks[cur].next_phys = blocks[n].next_phys;
                    if (blocks[n].next_phys >= 0)
                        blocks[blocks[n].next_phys].prev_phys = cur;
                    free_slots.push_back(n);
                }
                insert_free(cur);
                return true;
            }
        }
        return false;
    }
};

} // namespace

extern "C" {

void* tlsf_create(uint64_t size, uint64_t min_block) { return new TLSF(size, min_block); }
void tlsf_destroy(void* t) { delete (TLSF*)t; }
int64_t tlsf_alloc(void* t, uint64_t size, uint64_t align) {
    return ((TLSF*)t)->allocate(size, align);
}
int tlsf_free(void* t, uint64_t offset) { return ((TLSF*)t)->free_at(offset) ? 1 : 0; }
uint64_t tlsf_used(void* t) { return ((TLSF*)t)->used; }
uint64_t tlsf_total(void* t) { return ((TLSF*)t)->total; }

} // extern "C"
