// Native sokoban components: text level loader + A* solver.
//
// The port's copy of envpool_tpu/native/sokoban_native.cpp, counterpart of
// the reference's C++ tier for this family (envpool/sokoban/level_loader.cc,
// sokoban_node.{h,cc}, astar_log.cc): the hot host-side work — parsing big
// boxoban level banks and searching solutions — stays native; the exported
// flat-C API is consumed from Python via ctypes (no pybind11 dependency).
//
// Build (envpool_torch/native/__init__.py does it at first use, into
// build/native/ at the root of the checkout):
//   g++ -O2 -std=c++17 -shared -fPIC sokoban_native.cpp -o libsokoban.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <queue>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr uint8_t kWall = 0;
constexpr uint8_t kEmpty = 1;
constexpr uint8_t kTarget = 2;
constexpr uint8_t kBoxOnTarget = 3;
constexpr uint8_t kBox = 4;
constexpr uint8_t kPlayer = 5;
// (kPlayerOnTarget = 6 cannot appear in the text format)

std::string g_error;

int TileOf(char c) {
  switch (c) {
    case '#': return kWall;
    case ' ': return kEmpty;
    case '.': return kTarget;
    case '$': return kBox;
    case '@': return kPlayer;
    default: return -1;
  }
}

// solver move order Up, Right, Down, Left (sokoban_node.h:29-31) as
// (row, col) deltas; env action codes are 0=up 1=down 2=left 3=right
// (sokoban_envpool.h:31-35)
constexpr int kDx[4] = {-1, 0, 1, 0};   // row delta
constexpr int kDy[4] = {0, 1, 0, -1};   // col delta
constexpr int kRowColToEnv[4] = {0, 3, 1, 2};  // U, R, D, L -> env codes

struct Node {
  uint16_t player;
  std::vector<uint16_t> boxes;  // sorted
  bool operator==(const Node& o) const {
    return player == o.player && boxes == o.boxes;
  }
};

struct NodeHash {
  size_t operator()(const Node& n) const {
    size_t h = std::hash<uint16_t>()(n.player);
    for (uint16_t b : n.boxes) {
      h = h * 1000003u + b;
    }
    return h;
  }
};

}  // namespace

extern "C" {

const char* sokoban_last_error() { return g_error.c_str(); }

// Parse one level file into out[max_levels * dim * dim]; returns the
// number of levels or -1 (error text via sokoban_last_error()).
int sokoban_parse_file(const char* path, uint8_t* out, int max_levels,
                       int dim) {
  std::ifstream file(path);
  if (!file) {
    g_error = std::string("cannot open file ") + path;
    return -1;
  }
  int count = 0;
  std::string line;
  while (std::getline(file, line)) {
    if (line.empty() || line[0] != '#') {
      continue;
    }
    int dim_room = static_cast<int>(
        std::count(line.begin(), line.end(), '#'));
    if (dim_room != dim) {
      g_error = "level dim " + std::to_string(dim_room) +
                " != " + std::to_string(dim);
      return -1;
    }
    std::vector<uint8_t> level;
    level.reserve(dim * dim);
    int rows = 0;
    do {
      if (line.empty() || line[0] != '#') {
        break;
      }
      if (static_cast<int>(line.size()) != dim_room ||
          line.back() != '#') {
        g_error = "irregular line '" + line + "'";
        return -1;
      }
      for (char c : line) {
        int t = TileOf(c);
        if (t < 0) {
          g_error = std::string("bad character '") + c + "'";
          return -1;
        }
        level.push_back(static_cast<uint8_t>(t));
      }
      ++rows;
    } while (rows < dim_room && std::getline(file, line));
    if (rows != dim_room) {
      g_error = "room is not square";
      return -1;
    }
    if (count >= max_levels) {
      g_error = "too many levels";
      return -1;
    }
    std::memcpy(out + static_cast<size_t>(count) * dim * dim, level.data(),
                level.size());
    ++count;
  }
  if (count == 0) {
    g_error = std::string("no levels loaded from ") + path;
    return -1;
  }
  return count;
}

// A* solve; writes env action codes into actions_out. Returns the number
// of actions, -1 if unsolvable within node_limit, -2 on malformed input.
int sokoban_solve(const uint8_t* level, int dim, int node_limit,
                  int* actions_out, int max_actions) {
  std::vector<bool> walls(dim * dim, false);
  std::vector<bool> targets(dim * dim, false);
  Node start;
  start.player = 0;
  for (int i = 0; i < dim * dim; ++i) {
    switch (level[i]) {
      case kWall: walls[i] = true; break;
      case kTarget: targets[i] = true; break;
      case kBoxOnTarget:
        targets[i] = true;
        start.boxes.push_back(static_cast<uint16_t>(i));
        break;
      case kBox: start.boxes.push_back(static_cast<uint16_t>(i)); break;
      case kPlayer: start.player = static_cast<uint16_t>(i); break;
      default: break;
    }
  }
  std::sort(start.boxes.begin(), start.boxes.end());
  std::vector<uint16_t> target_list;
  for (int i = 0; i < dim * dim; ++i) {
    if (targets[i]) target_list.push_back(static_cast<uint16_t>(i));
  }
  if (target_list.empty() || start.boxes.empty()) return -2;

  auto wall_at = [&](int r, int c) {
    if (r < 0 || r >= dim || c < 0 || c >= dim) return true;
    return static_cast<bool>(walls[r * dim + c]);
  };
  auto corner_dead = [&](int pos) {
    if (targets[pos]) return false;
    int r = pos / dim, c = pos % dim;
    bool vert = wall_at(r - 1, c) || wall_at(r + 1, c);
    bool horz = wall_at(r, c - 1) || wall_at(r, c + 1);
    return vert && horz;
  };
  auto heuristic = [&](const Node& n) {
    int total = 0;
    for (uint16_t b : n.boxes) {
      int br = b / dim, bc = b % dim;
      int best = 1 << 20;
      for (uint16_t t : target_list) {
        int d = std::abs(br - t / dim) + std::abs(bc - t % dim);
        best = std::min(best, d);
      }
      total += best;
    }
    return total;
  };
  auto solved = [&](const Node& n) {
    for (uint16_t b : n.boxes) {
      if (!targets[b]) return false;
    }
    return true;
  };

  struct QEntry {
    int f;
    uint64_t order;
    Node node;
    bool operator>(const QEntry& o) const {
      return f > o.f || (f == o.f && order > o.order);
    }
  };
  std::priority_queue<QEntry, std::vector<QEntry>, std::greater<QEntry>> open;
  std::unordered_map<Node, int, NodeHash> g_cost;
  std::unordered_map<Node, std::pair<Node, int>, NodeHash> came;
  std::unordered_set<Node, NodeHash> closed;

  uint64_t order = 0;
  g_cost[start] = 0;
  open.push({heuristic(start), order++, start});
  int expanded = 0;
  while (!open.empty() && expanded < node_limit) {
    Node cur = open.top().node;
    open.pop();
    if (closed.count(cur)) continue;
    closed.insert(cur);
    ++expanded;
    if (solved(cur)) {
      std::vector<int> actions;
      Node s = cur;
      while (came.count(s)) {
        auto& [prev, a] = came[s];
        actions.push_back(a);
        s = prev;
      }
      std::reverse(actions.begin(), actions.end());
      if (static_cast<int>(actions.size()) > max_actions) return -3;
      for (size_t i = 0; i < actions.size(); ++i) {
        actions_out[i] = actions[i];
      }
      return static_cast<int>(actions.size());
    }
    int pr = cur.player / dim, pc = cur.player % dim;
    for (int a = 0; a < 4; ++a) {
      int nr = pr + kDx[a], nc = pc + kDy[a];
      if (wall_at(nr, nc)) continue;
      uint16_t np = static_cast<uint16_t>(nr * dim + nc);
      Node nxt = cur;
      auto it = std::find(nxt.boxes.begin(), nxt.boxes.end(), np);
      if (it != nxt.boxes.end()) {
        int br = nr + kDx[a], bc = nc + kDy[a];
        if (wall_at(br, bc)) continue;
        uint16_t nb = static_cast<uint16_t>(br * dim + bc);
        if (std::find(nxt.boxes.begin(), nxt.boxes.end(), nb) !=
            nxt.boxes.end()) {
          continue;
        }
        if (corner_dead(nb)) continue;
        *it = nb;
        std::sort(nxt.boxes.begin(), nxt.boxes.end());
      }
      nxt.player = np;
      if (closed.count(nxt)) continue;
      int ng = g_cost[cur] + 1;
      auto git = g_cost.find(nxt);
      if (git != g_cost.end() && git->second <= ng) continue;
      g_cost[nxt] = ng;
      came[nxt] = {cur, kRowColToEnv[a]};
      open.push({ng + heuristic(nxt), order++, nxt});
    }
  }
  return -1;
}

}  // extern "C"
