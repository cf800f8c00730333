// Native host-side hot paths for ouster_sdk_tpu_torch.
//
// The reference implements its ingest/codec layer in C++
// (ref: ouster_pcap/src/pcap.cpp, ip_reassembler.h, png_tools.cpp,
// parsing.cpp:1243-1289). This library provides the same host-bound fast
// paths behind a C ABI consumed via ctypes (no pybind11):
//   - pcap scan: link-layer + IPv4/UDP parse with fragment reassembly,
//     emitting packed payloads + per-datagram metadata in one pass
//   - PNG scanline unfilter (all five filters) for the OSF decoder
//   - CRC64 (ECMA-182, reflected) for lidar packet footers, batch CRC32
//   - frame staging: scatter packet payloads into the (n_pkts, words)
//     device upload buffer keyed by measurement id
//
// Built on first use by ouster_sdk_tpu_torch/utils/native.py into
// ouster_sdk_tpu_torch/kernels/_build/, keyed by a hash of this source and
// the machine (g++ -O3 -march=native -std=c++17 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CRC
// ---------------------------------------------------------------------------

static uint64_t crc64_table[256];
static bool crc64_init_done = false;

static void crc64_init() {
    const uint64_t poly = 0xC96C5795D7870F42ULL;  // ECMA-182 reflected
    for (uint32_t i = 0; i < 256; i++) {
        uint64_t crc = i;
        for (int k = 0; k < 8; k++) {
            crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
        }
        crc64_table[i] = crc;
    }
    crc64_init_done = true;
}

uint64_t onat_crc64(const uint8_t* data, uint64_t len) {
    if (!crc64_init_done) crc64_init();
    uint64_t crc = ~0ULL;
    for (uint64_t i = 0; i < len; i++) {
        crc = crc64_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
    }
    return ~crc;
}

// Validate the trailing-8-byte CRC64 of `count` packets, each `stride`
// bytes, stored contiguously. Returns number of failures; failure indices
// are written to `bad` (caller-sized).
int64_t onat_crc64_check_batch(const uint8_t* packets, int64_t count,
                               int64_t stride, int64_t* bad) {
    int64_t n_bad = 0;
    for (int64_t i = 0; i < count; i++) {
        const uint8_t* p = packets + i * stride;
        uint64_t want;
        std::memcpy(&want, p + stride - 8, 8);
        if (onat_crc64(p, stride - 8) != want) {
            bad[n_bad++] = i;
        }
    }
    return n_bad;
}

// ---------------------------------------------------------------------------
// PNG unfilter (ref: png_tools decode path; filters per the PNG spec)
// ---------------------------------------------------------------------------

int onat_png_unfilter(uint8_t* out, const uint8_t* rows, int64_t h,
                      int64_t stride, int64_t bpp) {
    std::vector<uint8_t> zero(stride, 0);
    const uint8_t* prev = zero.data();
    for (int64_t y = 0; y < h; y++) {
        const uint8_t* src = rows + y * (stride + 1);
        uint8_t filter = src[0];
        const uint8_t* cur = src + 1;
        uint8_t* dst = out + y * stride;
        switch (filter) {
            case 0:
                std::memcpy(dst, cur, stride);
                break;
            case 1:  // Sub
                for (int64_t i = 0; i < bpp; i++) dst[i] = cur[i];
                for (int64_t i = bpp; i < stride; i++)
                    dst[i] = cur[i] + dst[i - bpp];
                break;
            case 2:  // Up
                for (int64_t i = 0; i < stride; i++)
                    dst[i] = cur[i] + prev[i];
                break;
            case 3:  // Average
                for (int64_t i = 0; i < bpp; i++)
                    dst[i] = cur[i] + (prev[i] >> 1);
                for (int64_t i = bpp; i < stride; i++)
                    dst[i] = cur[i] + ((dst[i - bpp] + prev[i]) >> 1);
                break;
            case 4: {  // Paeth
                for (int64_t i = 0; i < bpp; i++)
                    dst[i] = cur[i] + prev[i];
                for (int64_t i = bpp; i < stride; i++) {
                    int a = dst[i - bpp], b = prev[i], c = prev[i - bpp];
                    int p = a + b - c;
                    int pa = p > a ? p - a : a - p;
                    int pb = p > b ? p - b : b - p;
                    int pc = p > c ? p - c : c - p;
                    int pred = (pa <= pb && pa <= pc) ? a
                               : (pb <= pc) ? b : c;
                    dst[i] = cur[i] + pred;
                }
                break;
            }
            default:
                return -1;
        }
        prev = dst;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// pcap scan (classic format) with IPv4 reassembly
// ---------------------------------------------------------------------------

struct FragKey {
    uint32_t src, dst;
    uint16_t id;
    uint8_t proto;
    bool operator<(const FragKey& o) const {
        if (src != o.src) return src < o.src;
        if (dst != o.dst) return dst < o.dst;
        if (id != o.id) return id < o.id;
        return proto < o.proto;
    }
};

struct FragState {
    std::vector<uint8_t> buf;
    int64_t total = -1;
    int64_t last_seen = 0;  // record counter at last fragment
    // covered byte ranges (merged, sorted): duplicate/overlapping fragments
    // must not count twice toward completion (the reference ip_reassembler
    // tracks holes explicitly)
    std::vector<std::pair<int64_t, int64_t>> ranges;

    void add_range(int64_t start, int64_t end) {
        std::vector<std::pair<int64_t, int64_t>> out;
        bool placed = false;
        for (auto& r : ranges) {
            if (r.second < start || end < r.first) {
                if (!placed && r.first > end) {
                    out.emplace_back(start, end);
                    placed = true;
                }
                out.push_back(r);
            } else {  // overlap/adjacent: merge
                start = start < r.first ? start : r.first;
                end = end > r.second ? end : r.second;
            }
        }
        if (!placed) out.emplace_back(start, end);
        // re-sort-merge in case the merged interval now touches a later one
        std::vector<std::pair<int64_t, int64_t>> fin;
        for (auto& r : out) {
            if (!fin.empty() && r.first <= fin.back().second) {
                if (r.second > fin.back().second)
                    fin.back().second = r.second;
            } else {
                fin.push_back(r);
            }
        }
        ranges.swap(fin);
    }

    bool complete() const {
        return total >= 0 && ranges.size() == 1 && ranges[0].first == 0 &&
               ranges[0].second >= total;
    }
};

static inline uint16_t be16(const uint8_t* p) {
    return (uint16_t)((p[0] << 8) | p[1]);
}
static inline uint32_t rd32le(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

// Single-pass scan: writes concatenated UDP payloads into `payloads`
// (capacity `payload_cap`), per-datagram metadata into parallel arrays of
// capacity `max_out`. Returns datagram count (negative on error).
// meta layout per datagram: offsets[i], sizes[i], ts_ns[i], ports[i]
// (src<<16|dst packed into u32), dst_ip[i].
int64_t onat_pcap_scan(const uint8_t* data, int64_t len, int swap_endian,
                       int ts_nano, int linktype, uint8_t* payloads,
                       int64_t payload_cap, int64_t* offsets, int64_t* sizes,
                       uint64_t* ts_ns, uint32_t* ports, uint32_t* dst_ips,
                       int64_t max_out) {
    std::map<FragKey, FragState> frags;
    int64_t pos = 24, n_out = 0, payload_pos = 0, rec_no = 0;
    bool truncated = false;

    auto rd32 = [&](int64_t off) -> uint32_t {
        uint32_t v = rd32le(data + off);
        if (swap_endian) v = __builtin_bswap32(v);
        return v;
    };

    while (pos + 16 <= len && n_out < max_out) {
        rec_no++;
        uint32_t ts_sec = rd32(pos), ts_frac = rd32(pos + 4);
        uint32_t incl = rd32(pos + 8);
        int64_t frame_off = pos + 16;
        pos = frame_off + incl;
        if (pos > len) break;

        const uint8_t* frame = data + frame_off;
        int64_t flen = incl;

        // link layer -> ip (IPv4 or IPv6 by ethertype / version nibble)
        const uint8_t* ip = nullptr;
        int64_t iplen = 0;
        if (linktype == 1) {  // ethernet (+ vlan tags)
            if (flen < 14) continue;
            int64_t off = 12;
            uint16_t ethertype = be16(frame + off);
            off += 2;
            while (ethertype == 0x8100 || ethertype == 0x88A8) {
                if (flen < off + 4) { ethertype = 0; break; }
                ethertype = be16(frame + off + 2);
                off += 4;
            }
            if (ethertype != 0x0800 && ethertype != 0x86DD) continue;
            ip = frame + off;
            iplen = flen - off;
        } else if (linktype == 101 || linktype == 228) {
            ip = frame;
            iplen = flen;
        } else if (linktype == 113) {  // linux SLL
            if (flen < 16) continue;
            uint16_t proto16 = be16(frame + 14);
            if (proto16 != 0x0800 && proto16 != 0x86DD) continue;
            ip = frame + 16;
            iplen = flen - 16;
        } else if (linktype == 276) {  // SLL2
            if (flen < 20) continue;
            uint16_t proto16 = be16(frame);
            if (proto16 != 0x0800 && proto16 != 0x86DD) continue;
            ip = frame + 20;
            iplen = flen - 20;
        } else if (linktype == 0) {  // null/loopback: u32 family, host order
            if (flen < 4) continue;
            uint32_t fam = rd32le(frame);
            uint32_t fam_be = __builtin_bswap32(fam);
            bool v4 = fam == 2 || fam_be == 2;
            bool v6 = fam == 10 || fam == 24 || fam == 28 || fam == 30 ||
                      fam_be == 10 || fam_be == 24 || fam_be == 28 ||
                      fam_be == 30;
            if (!v4 && !v6) continue;
            ip = frame + 4;
            iplen = flen - 4;
        } else {
            continue;
        }

        if (iplen < 1) continue;
        if ((ip[0] >> 4) == 6) {
            // IPv6: fixed 40 B header, UDP only (no extension headers —
            // matches the pure-Python reader's scope, io/pcap.py)
            if (iplen < 48 || ip[6] != 17) continue;
            int64_t plen6 = be16(ip + 4);
            if (plen6 > iplen - 40) plen6 = iplen - 40;
            const uint8_t* dg = ip + 40;
            if (plen6 < 8) continue;
            uint16_t sport = be16(dg), dport = be16(dg + 2);
            uint16_t ulen = be16(dg + 4);
            int64_t udplen6 = ulen >= 8 ? ulen - 8 : plen6 - 8;
            if (udplen6 > plen6 - 8) udplen6 = plen6 - 8;
            if (payload_pos + udplen6 > payload_cap) {
                truncated = true;
                break;
            }
            std::memcpy(payloads + payload_pos, dg + 8, udplen6);
            offsets[n_out] = payload_pos;
            sizes[n_out] = udplen6;
            ts_ns[n_out] = (uint64_t)ts_sec * 1000000000ULL
                           + (uint64_t)ts_frac * (ts_nano ? 1ULL : 1000ULL);
            ports[n_out] = ((uint32_t)sport << 16) | dport;
            // fold the 128-bit dst address into the u32 stream key
            uint32_t fold = 0;
            for (int k = 0; k < 4; k++) fold ^= rd32le(ip + 24 + 4 * k);
            dst_ips[n_out] = fold;
            payload_pos += udplen6;
            n_out++;
            continue;
        }
        if (iplen < 20 || (ip[0] >> 4) != 4) continue;
        int64_t ihl = (ip[0] & 0x0F) * 4;
        int64_t total_len = be16(ip + 2);
        if (total_len > iplen) total_len = iplen;
        uint16_t ip_id = be16(ip + 4);
        uint16_t ff = be16(ip + 6);
        bool more = (ff & 0x2000) != 0;
        int64_t frag_off = (int64_t)(ff & 0x1FFF) * 8;
        uint8_t proto = ip[9];
        if (proto != 17) continue;
        uint32_t src_ip = rd32le(ip + 12);
        uint32_t dst_ip = rd32le(ip + 16);

        const uint8_t* pl = ip + ihl;
        int64_t pllen = total_len - ihl;
        if (pllen <= 0) continue;

        const uint8_t* dgram = nullptr;
        int64_t dlen = 0;
        std::vector<uint8_t> assembled;

        if (frag_off == 0 && !more) {
            dgram = pl;
            dlen = pllen;
        } else {
            FragKey key{src_ip, dst_ip, ip_id, proto};
            // evict stale incomplete groups: on lossy captures each
            // lost-fragment datagram would otherwise leak a 64 KB
            // buffer for the whole scan (the reference ip_reassembler
            // expires entries too); 4096 records at MTU size far
            // exceeds any real in-flight reassembly window
            if (frags.size() > 1024) {
                for (auto it = frags.begin(); it != frags.end();) {
                    if (it->second.last_seen + 4096 < rec_no)
                        it = frags.erase(it);
                    else
                        ++it;
                }
            }
            FragState& st = frags[key];
            st.last_seen = rec_no;
            if ((int64_t)st.buf.size() < frag_off + pllen) {
                // reserve the max UDP datagram up front: per-fragment
                // geometric regrowth would memcpy the partial buffer ~20x
                // per reassembled lidar packet
                if (st.buf.capacity() < 65536) st.buf.reserve(65536);
                st.buf.resize(frag_off + pllen);
            }
            std::memcpy(st.buf.data() + frag_off, pl, pllen);
            st.add_range(frag_off, frag_off + pllen);
            if (!more) st.total = frag_off + pllen;
            if (st.complete()) {
                assembled.swap(st.buf);
                dlen = st.total;
                dgram = assembled.data();
                frags.erase(key);
            } else {
                continue;
            }
        }

        if (dlen < 8) continue;
        uint16_t sport = be16(dgram), dport = be16(dgram + 2);
        uint16_t udp_len = be16(dgram + 4);
        int64_t udplen = udp_len >= 8 ? udp_len - 8 : dlen - 8;
        if (udplen > dlen - 8) udplen = dlen - 8;
        if (payload_pos + udplen > payload_cap) {
            truncated = true;
            break;
        }

        std::memcpy(payloads + payload_pos, dgram + 8, udplen);
        offsets[n_out] = payload_pos;
        sizes[n_out] = udplen;
        ts_ns[n_out] = (uint64_t)ts_sec * 1000000000ULL
                       + (uint64_t)ts_frac * (ts_nano ? 1ULL : 1000ULL);
        ports[n_out] = ((uint32_t)sport << 16) | dport;
        dst_ips[n_out] = dst_ip;
        payload_pos += udplen;
        n_out++;
    }
    // early-stop sentinel: records remained but output capacity ran out;
    // -(n_out + 2) distinguishes truncation from error (-1)
    if (truncated || (pos + 16 <= len && n_out >= max_out))
        return -(n_out + 2);
    return n_out;
}

// ---------------------------------------------------------------------------
// frame staging: scatter packets into the (n_pkts, pkt_words) upload buffer
// ---------------------------------------------------------------------------

// packets: concatenated payload buffer + offsets/sizes from onat_pcap_scan
// (or any source). For each packet of size pkt_bytes, read the first
// column's measurement id at byte offset mid_off and place the packet at
// slot m_id / cols_per_packet. Returns number placed.
int64_t onat_stage_frame(const uint8_t* payloads, const int64_t* offsets,
                         const int64_t* sizes, int64_t count,
                         int64_t pkt_bytes, int64_t mid_off,
                         int64_t cols_per_packet, uint8_t* frame,
                         int64_t n_slots) {
    int64_t placed = 0;
    for (int64_t i = 0; i < count; i++) {
        if (sizes[i] != pkt_bytes) continue;
        const uint8_t* p = payloads + offsets[i];
        uint16_t mid;
        std::memcpy(&mid, p + mid_off, 2);
        int64_t slot = mid / cols_per_packet;
        if (slot < 0 || slot >= n_slots) continue;
        std::memcpy(frame + slot * pkt_bytes, p, pkt_bytes);
        placed++;
    }
    return placed;
}

// Group consecutive same-frame-id packets into zeroed frame slabs in one
// native pass (the host replay hot path; this machine is page-fault and
// Python-overhead bound, so the gather/scatter must not round-trip through
// numpy). Packets are `count` offsets into `payloads`, each `pkt_bytes`
// long. frame_id is read as a 64-bit little-endian load at byte `fid_byte`
// >> fid_shift & fid_mask; the column slot from the u16 measurement id at
// `mid_byte`. Emits at most max_frames slabs of (n_slots * pkt_bytes)
// bytes into out_frames (memset-zeroed here), with per-frame id and the
// first packet's timestamp. Stops BEFORE starting frame max_frames+1 so
// callers can resume; *out_nframes = frames emitted; returns packets
// consumed.
int64_t onat_group_frames(const uint8_t* payloads, const int64_t* offsets,
                          const uint64_t* ts_in, int64_t count,
                          int64_t pkt_bytes, int64_t fid_byte, int fid_shift,
                          uint64_t fid_mask, int64_t mid_byte,
                          int64_t cols_per_packet, int64_t n_slots,
                          uint8_t* out_frames, int64_t* out_fids,
                          uint64_t* out_ts, int64_t max_frames,
                          int64_t* out_nframes, int64_t* io_released) {
    int64_t frame_bytes = n_slots * pkt_bytes;
    int64_t nf = 0, i = 0;
    int64_t cur_fid = -1;
    int64_t released = io_released ? *io_released : -1;
    uint8_t* slab = nullptr;
    for (; i < count; i++) {
        const uint8_t* p = payloads + offsets[i];
        uint64_t fid64;
        std::memcpy(&fid64, p + fid_byte, 8);
        int64_t fid = (int64_t)((fid64 >> fid_shift) & fid_mask);
        if (fid != cur_fid) {
            // batcher boundary semantics (ref: lidar_scan.cpp:1505-1591):
            // drop one-older stragglers while building, and duplicates /
            // stragglers of the released frame right after a close
            if (cur_fid >= 0 &&
                fid == (int64_t)((uint64_t)(cur_fid - 1) & fid_mask))
                continue;
            if (cur_fid < 0 && released >= 0 &&
                (fid == released ||
                 released == (int64_t)((uint64_t)(fid + 1) & fid_mask)))
                continue;
            if (cur_fid >= 0) released = cur_fid;
            if (nf >= max_frames) break;  // resume from packet i next call
            slab = out_frames + nf * frame_bytes;
            std::memset(slab, 0, frame_bytes);
            out_fids[nf] = fid;
            out_ts[nf] = ts_in ? ts_in[i] : 0;
            cur_fid = fid;
            nf++;
        }
        uint16_t mid;
        std::memcpy(&mid, p + mid_byte, 2);
        int64_t slot = mid / cols_per_packet;
        if (slot < 0 || slot >= n_slots) continue;
        std::memcpy(slab + slot * pkt_bytes, p, pkt_bytes);
    }
    if (io_released) {
        // same carry-over contract as onat_group_frames_planar: the
        // frame we stopped inside re-opens next call, so persist the
        // id released BEFORE it — without this, a chunk boundary
        // landing on a straggler/duplicate re-admits dropped packets
        *io_released = released;
    }
    *out_nframes = nf;
    return i;
}

// Word-planar frame staging: the layout the TPU kernel wants, built at
// host memcpy speed. For each frame, pixel word k of pixel row p at
// column C lands at planes[k][p][C] (pw, h, W) u32, and column-header
// word q at colhdr[q][C] (chw, W) u32 — so the device kernel needs no
// transpose and no lane-strided selects (both measured slower than the
// projection itself). Loop order (k, p, c-within-packet) keeps writes in
// 64-byte bursts while the 24-33 kB packet stays cache-resident.
// Same grouping/resume contract as onat_group_frames.
//
// word_sel/n_sel (optional; NULL/0 = all words): stage only the listed
// packet-word planes, compacted in the given order — out_planes is then
// (max_frames, n_sel, h, W). Projection-only consumers (RANGE words)
// cut the staged+memset bytes to n_sel/pw of the full layout on top of
// the h2d savings (the Python-side subset copy this replaces still
// staged every word).
//
// Batcher frame-boundary semantics (ref: lidar_scan.cpp:1505-1591): while
// building frame F, a packet whose id is (F-1 mod max) is a straggler from
// the released frame and is dropped; any other id closes F and opens a new
// frame. Immediately after a close, duplicates of the released frame and
// one-older stragglers are dropped until a fresh id arrives. io_released
// (optional, 1 x i64, -1 = none) carries the released-frame id across
// resumed calls so the drop rules survive the max_frames boundary.
//
// Per-packet scan headers (all optional, NULL = skip):
//   out_pkt_ts   (max_frames, n_pkts) u64 — host timestamp by packet slot
//   out_pkt_hdrs (max_frames, n_pkts, hw_words) u32 — packet header words
//       by packet slot (alert_flags / init_id / serial live here)
//   out_first_hdr (max_frames, hw_words) u32 — header of the packet that
//       OPENED the frame in arrival order (frame_status + countdowns come
//       from it, ref: lidar_scan.cpp:1546-1552)
//
// ftr_words: LEGACY support — also stage the last ftr_words u32 of each
// column block (the col FOOTER, where LEGACY keeps its 32-bit status,
// ref: parsing.cpp:516-530) into colhdr rows [chw, chw+ftr_words); the
// staged colhdr layout is then (chw + ftr_words, W) u32 per frame.
int64_t onat_group_frames_planar(
    const uint8_t* payloads, const int64_t* offsets, const uint64_t* ts_in,
    int64_t count, int64_t pkt_bytes, int64_t fid_byte, int fid_shift,
    uint64_t fid_mask, int64_t hw_bytes, int64_t cw_bytes, int64_t chw_bytes,
    int64_t mid_byte_in_col, int64_t cpp, int64_t h, int64_t pw, int64_t W,
    uint8_t* out_planes, uint8_t* out_colhdr, int64_t* out_fids,
    uint64_t* out_ts, int64_t max_frames, int64_t* out_nframes,
    const int64_t* word_sel, int64_t n_sel,
    uint64_t* out_pkt_ts, uint8_t* out_pkt_hdrs, uint8_t* out_first_hdr,
    int64_t* io_released, int64_t ftr_words) {
    const int64_t pw_out = (word_sel && n_sel > 0) ? n_sel : pw;
    const int64_t plane_bytes = (int64_t)pw_out * h * W * 4;
    const int64_t chw = chw_bytes / 4;
    const int64_t colhdr_bytes = (chw + ftr_words) * W * 4;
    const int64_t n_pkts = W / cpp;
    int64_t nf = 0, i = 0;
    int64_t cur_fid = -1;
    int64_t released = io_released ? *io_released : -1;
    uint8_t* planes = nullptr;
    uint8_t* colhdr = nullptr;
    for (; i < count; i++) {
        const uint8_t* p = payloads + offsets[i];
        uint64_t fid64;
        std::memcpy(&fid64, p + fid_byte, 8);
        int64_t fid = (int64_t)((fid64 >> fid_shift) & fid_mask);
        if (fid != cur_fid) {
            if (cur_fid >= 0 &&
                fid == (int64_t)((uint64_t)(cur_fid - 1) & fid_mask))
                continue;  // straggler from the frame we just released
            if (cur_fid < 0 && released >= 0 &&
                (fid == released ||
                 released == (int64_t)((uint64_t)(fid + 1) & fid_mask)))
                continue;  // duplicate / straggler right after a close
            if (cur_fid >= 0) released = cur_fid;
            if (nf >= max_frames) break;
            planes = out_planes + nf * plane_bytes;
            colhdr = out_colhdr + nf * colhdr_bytes;
            std::memset(planes, 0, plane_bytes);
            std::memset(colhdr, 0, colhdr_bytes);
            if (out_pkt_ts)
                std::memset(out_pkt_ts + nf * n_pkts, 0, n_pkts * 8);
            if (out_pkt_hdrs)
                std::memset(out_pkt_hdrs + nf * n_pkts * hw_bytes, 0,
                            n_pkts * hw_bytes);
            if (out_first_hdr)
                std::memcpy(out_first_hdr + nf * hw_bytes, p, hw_bytes);
            out_fids[nf] = fid;
            out_ts[nf] = ts_in ? ts_in[i] : 0;
            cur_fid = fid;
            nf++;
        }
        if (out_pkt_ts || out_pkt_hdrs) {
            uint16_t mid_first;
            std::memcpy(&mid_first, p + hw_bytes + mid_byte_in_col, 2);
            int64_t slot = mid_first / cpp;
            if (slot >= 0 && slot < n_pkts) {
                if (out_pkt_ts)
                    out_pkt_ts[(nf - 1) * n_pkts + slot] =
                        ts_in ? ts_in[i] : 0;
                if (out_pkt_hdrs)
                    std::memcpy(out_pkt_hdrs +
                                    ((nf - 1) * n_pkts + slot) * hw_bytes,
                                p, hw_bytes);
            }
        }
        for (int64_t c = 0; c < cpp; c++) {
            const uint8_t* col = p + hw_bytes + c * cw_bytes;
            uint16_t mid;
            std::memcpy(&mid, col + mid_byte_in_col, 2);
            if (mid >= W) continue;
            for (int64_t q = 0; q < chw; q++)
                std::memcpy(colhdr + (q * W + mid) * 4, col + q * 4, 4);
            for (int64_t q = 0; q < ftr_words; q++)
                std::memcpy(colhdr + ((chw + q) * W + mid) * 4,
                            col + cw_bytes - (ftr_words - q) * 4, 4);
        }
        // pixel planes: (k, p, c) order -> 4 B * cpp contiguous column
        // runs would need per-column mid; columns in a packet are
        // consecutive on the wire, so use the first column's mid as the
        // base and bounds-check the run
        uint16_t mid0;
        std::memcpy(&mid0, p + hw_bytes + mid_byte_in_col, 2);
        if (mid0 + cpp > W || (mid0 % cpp) != 0) {
            // non-aligned packet: per-column scatter fallback
            for (int64_t c = 0; c < cpp; c++) {
                const uint8_t* col = p + hw_bytes + c * cw_bytes;
                uint16_t mid;
                std::memcpy(&mid, col + mid_byte_in_col, 2);
                if (mid >= W) continue;
                const uint8_t* px = col + chw_bytes;
                for (int64_t pp = 0; pp < h; pp++)
                    for (int64_t ko = 0; ko < pw_out; ko++) {
                        int64_t k = word_sel && n_sel > 0 ? word_sel[ko]
                                                          : ko;
                        std::memcpy(
                            planes + ((ko * h + pp) * W + mid) * 4,
                            px + (pp * pw + k) * 4, 4);
                    }
            }
            continue;
        }
        for (int64_t ko = 0; ko < pw_out; ko++) {
            int64_t k = word_sel && n_sel > 0 ? word_sel[ko] : ko;
            for (int64_t pp = 0; pp < h; pp++) {
                uint8_t* dst = planes + ((ko * h + pp) * W + mid0) * 4;
                const uint8_t* src =
                    p + hw_bytes + chw_bytes + (pp * pw + k) * 4;
                for (int64_t c = 0; c < cpp; c++)
                    std::memcpy(dst + c * 4, src + c * cw_bytes, 4);
            }
        }
    }
    if (io_released) {
        // a resumed call restarts with cur_fid = -1; the frame we stopped
        // inside will be re-opened from packet i, so the released id the
        // next call must honor is the one BEFORE it
        *io_released = released;
    }
    *out_nframes = nf;
    return i;
}

// Bit-packed frame staging: the wire-rate layout for link-bound ingest.
// Lidar ranges are 15/19-bit fields shipped in 32-bit words; when the
// host->device link (PCIe) is the bottleneck,
// staging the raw words wastes 40-60% of the link. This pack extracts
// each selected field's `nbits` bits per pixel and emits a dense
// little-endian bitstream per (field, pixel row): pixel j of a row
// occupies bits [nbits*j, nbits*(j+1)) of that row's stream. Out planes
// are (max_frames, n_fields, h, W*nbits/32) u32; the device unpacks with
// a fixed 32-pixel -> nbits-word block pattern of static shifts
// (ops/packed.py) that XLA fuses into the projection.
//
// Requirements (caller pre-verifies, ops layer falls back to planar
// staging otherwise): every packet's first measurement id is aligned to
// cols-per-packet (so each packet's cpp columns are byte-aligned in the
// stream: cpp*nbits % 8 == 0), and W % 32 == 0.
// fields: n_fields x (word, bit) pairs. Grouping/drop/resume semantics
// and col-header/pkt-ts/hdr outputs match onat_group_frames_planar.
int64_t onat_group_frames_packed(
    const uint8_t* payloads, const int64_t* offsets, const uint64_t* ts_in,
    int64_t count, int64_t pkt_bytes, int64_t fid_byte, int fid_shift,
    uint64_t fid_mask, int64_t hw_bytes, int64_t cw_bytes, int64_t chw_bytes,
    int64_t mid_byte_in_col, int64_t cpp, int64_t h, int64_t pw, int64_t W,
    const int64_t* field_words, const int64_t* field_bits, int64_t n_fields,
    int64_t nbits,
    uint8_t* out_planes, uint8_t* out_colhdr, int64_t* out_fids,
    uint64_t* out_ts, int64_t max_frames, int64_t* out_nframes,
    int64_t* io_released) {
    const int64_t group_bytes = cpp * nbits / 8;   // per packet, per row
    const int64_t row_bytes = (W / cpp) * group_bytes;
    const int64_t plane_bytes = (int64_t)n_fields * h * row_bytes;
    const int64_t colhdr_bytes = (int64_t)(chw_bytes / 4) * W * 4;
    const int64_t chw = chw_bytes / 4;
    const uint32_t vmask = (nbits >= 32) ? 0xFFFFFFFFu
                                         : ((1u << nbits) - 1u);
    int64_t nf = 0, i = 0;
    int64_t cur_fid = -1;
    int64_t released = io_released ? *io_released : -1;
    uint8_t* planes = nullptr;
    uint8_t* colhdr = nullptr;
    for (; i < count; i++) {
        const uint8_t* p = payloads + offsets[i];
        uint64_t fid64;
        std::memcpy(&fid64, p + fid_byte, 8);
        int64_t fid = (int64_t)((fid64 >> fid_shift) & fid_mask);
        if (fid != cur_fid) {
            if (cur_fid >= 0 &&
                fid == (int64_t)((uint64_t)(cur_fid - 1) & fid_mask))
                continue;
            if (cur_fid < 0 && released >= 0 &&
                (fid == released ||
                 released == (int64_t)((uint64_t)(fid + 1) & fid_mask)))
                continue;
            if (cur_fid >= 0) released = cur_fid;
            if (nf >= max_frames) break;
            planes = out_planes + nf * plane_bytes;
            colhdr = out_colhdr + nf * colhdr_bytes;
            std::memset(planes, 0, plane_bytes);
            std::memset(colhdr, 0, colhdr_bytes);
            out_fids[nf] = fid;
            out_ts[nf] = ts_in ? ts_in[i] : 0;
            cur_fid = fid;
            nf++;
        }
        for (int64_t c = 0; c < cpp; c++) {
            const uint8_t* col = p + hw_bytes + c * cw_bytes;
            uint16_t mid;
            std::memcpy(&mid, col + mid_byte_in_col, 2);
            if (mid >= W) continue;
            for (int64_t q = 0; q < chw; q++)
                std::memcpy(colhdr + (q * W + mid) * 4, col + q * 4, 4);
        }
        uint16_t mid0;
        std::memcpy(&mid0, p + hw_bytes + mid_byte_in_col, 2);
        if (mid0 + cpp > W || (mid0 % cpp) != 0) continue;  // pre-checked
        const int64_t slot = mid0 / cpp;
        for (int64_t k = 0; k < n_fields; k++) {
            const int64_t fw = field_words[k], fb = field_bits[k];
            for (int64_t pp = 0; pp < h; pp++) {
                const uint8_t* src =
                    p + hw_bytes + chw_bytes + (pp * pw + fw) * 4;
                uint8_t* dst = planes + (k * h + pp) * row_bytes
                               + slot * group_bytes;
                uint64_t bitbuf = 0;
                int nacc = 0;
                for (int64_t c = 0; c < cpp; c++) {
                    uint32_t v;
                    std::memcpy(&v, src + c * cw_bytes, 4);
                    v = (v >> fb) & vmask;
                    bitbuf |= (uint64_t)v << nacc;
                    nacc += (int)nbits;
                    while (nacc >= 8) {
                        *dst++ = (uint8_t)bitbuf;
                        bitbuf >>= 8;
                        nacc -= 8;
                    }
                }
            }
        }
    }
    if (io_released) *io_released = released;
    *out_nframes = nf;
    return i;
}

// BP64 encode (format spec + rationale: ops/bp64.py): one frame's
// selected word planes (F, h, W) u32 -> dense word-aligned payload +
// width/anchor side arrays. Per 64-px block: anchor = first non-zero,
// carry chain glides over dropouts (delta 0) with a 64-bit zero mask
// emitted only when needed (width byte bit 7), successor deltas zigzag
// bit-packed at the block's max width (exactly 2*width words). Values
// are extracted as (word >> field_bit) & ((1<<nbits)-1), matching the
// packed staging. Returns payload words written, or -1 when cap_words
// would overflow (caller grows and retries).
int64_t onat_bp64_encode(const uint32_t* planes, int64_t F, int64_t h,
                         int64_t W, const int64_t* field_bits,
                         int64_t nbits, uint32_t* payload,
                         int64_t cap_words, uint8_t* widths,
                         uint32_t* anchors) {
    const uint32_t vmask = (nbits >= 32) ? 0xFFFFFFFFu
                                         : ((1u << nbits) - 1u);
    const int64_t nb = W / 64;
    int64_t pos = 0, bi = 0;
    for (int64_t f = 0; f < F; f++) {
        const uint32_t fb = (uint32_t)field_bits[f];
        for (int64_t r = 0; r < h; r++) {
            const uint32_t* row = planes + (f * h + r) * W;
            for (int64_t b = 0; b < nb; b++, bi++) {
                uint32_t v[64], z[64];
                uint64_t zmask = 0;
                for (int j = 0; j < 64; j++) {
                    v[j] = (row[b * 64 + j] >> fb) & vmask;
                    if (v[j] == 0) zmask |= 1ull << j;
                }
                uint32_t anchor = 0;
                for (int j = 0; j < 64; j++)
                    if (v[j]) { anchor = v[j]; break; }
                uint32_t prev = anchor, orz = 0;
                for (int j = 0; j < 64; j++) {
                    uint32_t c = v[j] ? v[j] : prev;
                    uint32_t d = c - prev;
                    z[j] = (d << 1) ^ (uint32_t)(-(int32_t)(d >> 31));
                    orz |= z[j];
                    prev = c;
                }
                // bitlength(OR) == bitlength(max): OR >= max and both
                // are < the same power of two
                const int wbits = orz ? 32 - __builtin_clz(orz) : 0;
                const int hasz = zmask ? 1 : 0;
                if (pos + 2 * wbits + 2 * hasz > cap_words) return -1;
                widths[bi] = (uint8_t)wbits | (uint8_t)(hasz << 7);
                anchors[bi] = anchor;
                if (hasz) {
                    payload[pos++] = (uint32_t)zmask;
                    payload[pos++] = (uint32_t)(zmask >> 32);
                }
                if (wbits) {
                    uint64_t bitbuf = 0;
                    int nacc = 0;
                    uint32_t* dst = payload + pos;
                    for (int j = 0; j < 64; j++) {
                        bitbuf |= (uint64_t)z[j] << nacc;
                        nacc += wbits;
                        while (nacc >= 32) {
                            *dst++ = (uint32_t)bitbuf;
                            bitbuf >>= 32;
                            nacc -= 32;
                        }
                    }
                    pos += 2 * wbits;  // 64*wbits bits == 2*wbits words
                }
            }
        }
    }
    return pos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// UDP batch receive (live ingest fast path)
// ---------------------------------------------------------------------------

#include <sys/socket.h>
#include <sys/time.h>
#include <time.h>

extern "C" {

// Drain up to max_msgs datagrams from a non-blocking UDP socket with
// recvmmsg (ref: the reference's socket recv loop,
// sensor_packet_source.cpp:343-548; batching amortizes syscall cost at
// high packet rates). Returns the number received; payloads are packed
// back-to-back at `stride` bytes with per-message sizes and a single
// host timestamp (ns) for the batch written to *ts_ns.
int64_t onat_udp_recv_batch(int fd, uint8_t* payloads, int64_t stride,
                            int64_t max_msgs, int64_t* sizes,
                            uint64_t* ts_ns) {
    if (max_msgs > 1024) max_msgs = 1024;
    static thread_local std::vector<mmsghdr> hdrs;
    static thread_local std::vector<iovec> iovs;
    hdrs.resize(max_msgs);
    iovs.resize(max_msgs);
    for (int64_t i = 0; i < max_msgs; i++) {
        iovs[i].iov_base = payloads + i * stride;
        iovs[i].iov_len = stride;
        std::memset(&hdrs[i], 0, sizeof(mmsghdr));
        hdrs[i].msg_hdr.msg_iov = &iovs[i];
        hdrs[i].msg_hdr.msg_iovlen = 1;
    }
    int n = recvmmsg(fd, hdrs.data(), (unsigned)max_msgs, MSG_DONTWAIT,
                     nullptr);
    if (n <= 0) return 0;
    timespec t;
    clock_gettime(CLOCK_REALTIME, &t);
    *ts_ns = (uint64_t)t.tv_sec * 1000000000ULL + (uint64_t)t.tv_nsec;
    for (int i = 0; i < n; i++) sizes[i] = hdrs[i].msg_len;
    return n;
}

}  // extern "C"
