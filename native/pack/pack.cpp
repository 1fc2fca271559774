// Resource archive library: the cfnptr/pack analog.
//
// The reference ships assets in `pack` archives read by ResourceSystem in
// release builds (include/garden/system/resource.hpp:28-30,183-185:
// pack::Reader). This is the engine's native equivalent: a C++ archive
// writer/reader with zlib compression and an FNV-1a path index, exposed to
// Python through a C ABI (ctypes — no pybind11 in the toolchain).
//
// Format (little-endian):
//   header:  magic "GPK1" | u32 item_count | u64 index_offset
//   blobs:   item data (zlib-compressed), concatenated
//   index:   per item: u64 path_hash | u32 path_len | path bytes |
//            u64 offset | u64 stored_size | u64 raw_size | u8 compressed
//
// Build: native/build.sh (g++ -shared -O2 -fPIC pack.cpp -lz)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

constexpr char MAGIC[4] = {'G', 'P', 'K', '1'};

uint64_t fnv1a(const char* s, size_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < n; i++) {
        h ^= (uint8_t)s[i];
        h *= 1099511628211ULL;
    }
    return h;
}

struct Item {
    std::string path;
    uint64_t hash;
    uint64_t offset;
    uint64_t stored_size;
    uint64_t raw_size;
    uint8_t compressed;
};

struct Writer {
    FILE* f;
    std::vector<Item> items;
    uint64_t cursor;
};

struct Reader {
    FILE* f;
    std::vector<Item> items;
};

template <typename T>
bool write_pod(FILE* f, const T& v) {
    return fwrite(&v, sizeof(T), 1, f) == 1;
}

template <typename T>
bool read_pod(FILE* f, T* v) {
    return fread(v, sizeof(T), 1, f) == 1;
}

}  // namespace

extern "C" {

Writer* gpk_writer_create(const char* path) {
    FILE* f = fopen(path, "wb");
    if (!f) return nullptr;
    // placeholder header, patched in finish()
    char magic[4] = {0, 0, 0, 0};
    uint32_t count = 0;
    uint64_t index_offset = 0;
    fwrite(magic, 4, 1, f);
    write_pod(f, count);
    write_pod(f, index_offset);
    auto* w = new Writer{f, {}, 16};
    return w;
}

int gpk_writer_add(Writer* w, const char* name, const uint8_t* data,
                   uint64_t size) {
    if (!w) return -1;
    uLongf bound = compressBound((uLong)size);
    std::vector<uint8_t> buf(bound);
    uint8_t compressed = 0;
    uint64_t stored = size;
    const uint8_t* payload = data;
    if (size > 64 &&
        compress2(buf.data(), &bound, data, (uLong)size, 6) == Z_OK &&
        bound < size) {
        compressed = 1;
        stored = bound;
        payload = buf.data();
    }
    if (fwrite(payload, 1, stored, w->f) != stored) return -2;
    Item it;
    it.path = name;
    it.hash = fnv1a(name, strlen(name));
    it.offset = w->cursor;
    it.stored_size = stored;
    it.raw_size = size;
    it.compressed = compressed;
    w->items.push_back(it);
    w->cursor += stored;
    return (int)w->items.size() - 1;
}

int gpk_writer_finish(Writer* w) {
    if (!w) return -1;
    uint64_t index_offset = w->cursor;
    for (const auto& it : w->items) {
        write_pod(w->f, it.hash);
        uint32_t n = (uint32_t)it.path.size();
        write_pod(w->f, n);
        fwrite(it.path.data(), 1, n, w->f);
        write_pod(w->f, it.offset);
        write_pod(w->f, it.stored_size);
        write_pod(w->f, it.raw_size);
        write_pod(w->f, it.compressed);
    }
    fseek(w->f, 0, SEEK_SET);
    fwrite(MAGIC, 4, 1, w->f);
    uint32_t count = (uint32_t)w->items.size();
    write_pod(w->f, count);
    write_pod(w->f, index_offset);
    fclose(w->f);
    delete w;
    return 0;
}

Reader* gpk_reader_open(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    char magic[4];
    uint32_t count;
    uint64_t index_offset;
    if (fread(magic, 4, 1, f) != 1 || memcmp(magic, MAGIC, 4) != 0 ||
        !read_pod(f, &count) || !read_pod(f, &index_offset)) {
        fclose(f);
        return nullptr;
    }
    auto* r = new Reader{f, {}};
    fseek(f, (long)index_offset, SEEK_SET);
    for (uint32_t i = 0; i < count; i++) {
        Item it;
        uint32_t n;
        if (!read_pod(f, &it.hash) || !read_pod(f, &n)) { delete r; fclose(f); return nullptr; }
        it.path.resize(n);
        if (fread(&it.path[0], 1, n, f) != n) { delete r; fclose(f); return nullptr; }
        read_pod(f, &it.offset);
        read_pod(f, &it.stored_size);
        read_pod(f, &it.raw_size);
        read_pod(f, &it.compressed);
        r->items.push_back(std::move(it));
    }
    return r;
}

uint32_t gpk_reader_count(Reader* r) {
    return r ? (uint32_t)r->items.size() : 0;
}

int gpk_reader_find(Reader* r, const char* name) {
    if (!r) return -1;
    uint64_t h = fnv1a(name, strlen(name));
    for (size_t i = 0; i < r->items.size(); i++) {
        if (r->items[i].hash == h && r->items[i].path == name) return (int)i;
    }
    return -1;
}

uint64_t gpk_reader_item_size(Reader* r, int index) {
    if (!r || index < 0 || (size_t)index >= r->items.size()) return 0;
    return r->items[index].raw_size;
}

int gpk_reader_item_name(Reader* r, int index, char* out, uint32_t cap) {
    if (!r || index < 0 || (size_t)index >= r->items.size()) return -1;
    const auto& p = r->items[index].path;
    uint32_t n = (uint32_t)p.size();
    if (n + 1 > cap) return -2;
    memcpy(out, p.data(), n);
    out[n] = 0;
    return (int)n;
}

int gpk_reader_read(Reader* r, int index, uint8_t* out) {
    if (!r || index < 0 || (size_t)index >= r->items.size()) return -1;
    const Item& it = r->items[index];
    fseek(r->f, (long)it.offset, SEEK_SET);
    if (!it.compressed) {
        return fread(out, 1, it.raw_size, r->f) == it.raw_size ? 0 : -2;
    }
    std::vector<uint8_t> buf(it.stored_size);
    if (fread(buf.data(), 1, it.stored_size, r->f) != it.stored_size) return -2;
    uLongf raw = (uLongf)it.raw_size;
    if (uncompress(out, &raw, buf.data(), (uLong)it.stored_size) != Z_OK)
        return -3;
    return raw == it.raw_size ? 0 : -4;
}

void gpk_reader_close(Reader* r) {
    if (r) {
        fclose(r->f);
        delete r;
    }
}

}  // extern "C"
