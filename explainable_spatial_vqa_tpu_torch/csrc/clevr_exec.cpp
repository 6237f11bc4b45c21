// Native symbolic CLEVR program execution engine: a copy of the JAX
// package's native/clevr_exec.cpp, built by clevr/native.py with g++ at
// first use (a host library; nothing here runs on the card).
//
// The offline annotation sweep executes ~700k programs x <=27 steps over
// scene graphs; in Python this is the slowest loop of data preparation (the
// CLEVR reference annotator re-executes the whole program prefix at every
// step, preprocess_scenes/preprocess_continousv3.py:354-467).  This engine
// executes packed programs over packed scenes; the Python layer
// (clevr/native.py) packs scenes and programs and decodes the outputs.
//
// Data contract (all little-endian, C-contiguous):
//   scene objects:  n_obj, attrs int32[n_obj*4]  (color, shape, size, material)
//   relationships:  CSR per relation r in {left,right,front,behind}:
//                   rel_offsets int32[4*(n_obj+1)], rel_values int32[nnz]
//   program:        steps int32[n_steps*5]: fn, dep0, dep1, side_attr, side_value
//                   (deps -1 when absent; side_attr: 0..3 attribute, 4 relation,
//                    -1 none)
//   output:         int32[n_steps*3]: kind, value, obj_bitmask
//     kind: 0 = object set (bitmask), 1 = unique object (value = index,
//           bitmask = 1<<index), 2 = int, 3 = bool, 4 = attribute value,
//           5 = INVALID, 6 = poisoned (post-INVALID / post-error)
//
// Semantics parity with the Python executor (clevr/executor.py), including
// positional poisoning: every step after the first INVALID or error reads a
// truncated prefix in the reference and yields "None".

#include <cstdint>
#include <cstring>

namespace {

enum Fn : int32_t {
  FN_SCENE = 0,
  FN_FILTER = 1,       // side_attr = attribute, side_value = value code
  FN_UNIQUE = 2,
  FN_RELATE = 3,       // side_value = relation id
  FN_UNION = 4,
  FN_INTERSECT = 5,
  FN_COUNT = 6,
  FN_EXIST = 7,
  FN_QUERY = 8,        // side_attr = attribute
  FN_EQUAL_ATTR = 9,   // compares attribute values
  FN_EQUAL_INT = 10,
  FN_LESS = 11,
  FN_GREATER = 12,
  FN_SAME = 13,        // side_attr = attribute
  FN_EQUAL_OBJECT = 14,
};

enum Kind : int32_t {
  K_SET = 0,
  K_OBJ = 1,
  K_INT = 2,
  K_BOOL = 3,
  K_ATTR = 4,
  K_INVALID = 5,
  K_POISONED = 6,
};

struct Value {
  int32_t kind;
  int32_t value;     // int/bool/attr value or unique object index
  uint32_t mask;     // object-set bitmask (objects < 32; CLEVR max 10)
};

inline int popcount32(uint32_t x) {
#if defined(__GNUC__)
  return __builtin_popcount(x);
#else
  int c = 0;
  while (x) { c += x & 1; x >>= 1; }
  return c;
#endif
}

}  // namespace

extern "C" {

// Execute one program.  Returns 0 on success (including INVALID/poisoned
// outcomes — those are encoded in the output kinds), -1 on malformed input.
int clevr_execute(
    int32_t n_obj,
    const int32_t* attrs,          // [n_obj * 4]
    const int32_t* rel_offsets,    // [4 * (n_obj + 1)]
    const int32_t* rel_values,     // [nnz]
    int32_t n_steps,
    const int32_t* steps,          // [n_steps * 5]
    int32_t* out                   // [n_steps * 3]
) {
  if (n_obj < 0 || n_obj > 31 || n_steps < 0) return -1;
  Value vals[64];
  bool poisoned = false;

  for (int32_t s = 0; s < n_steps && s < 64; ++s) {
    const int32_t fn = steps[s * 5 + 0];
    const int32_t dep0 = steps[s * 5 + 1];
    const int32_t dep1 = steps[s * 5 + 2];
    const int32_t side_attr = steps[s * 5 + 3];
    const int32_t side_value = steps[s * 5 + 4];

    Value r = {K_POISONED, 0, 0};
    if (!poisoned) {
      const Value* a = dep0 >= 0 && dep0 < s ? &vals[dep0] : nullptr;
      const Value* b = dep1 >= 0 && dep1 < s ? &vals[dep1] : nullptr;
      bool error = false;

      switch (fn) {
        case FN_SCENE: {
          r.kind = K_SET;
          r.mask = n_obj >= 32 ? 0u : ((n_obj == 31) ? 0x7fffffffu
                                                     : ((1u << n_obj) - 1u));
          break;
        }
        case FN_FILTER: {
          if (!a || a->kind != K_SET) { error = true; break; }
          r.kind = K_SET;
          r.mask = 0;
          for (int32_t i = 0; i < n_obj; ++i) {
            if ((a->mask >> i) & 1u) {
              if (attrs[i * 4 + side_attr] == side_value) r.mask |= (1u << i);
            }
          }
          break;
        }
        case FN_UNIQUE: {
          if (!a || a->kind != K_SET) { error = true; break; }
          if (popcount32(a->mask) != 1) { r.kind = K_INVALID; break; }
          r.kind = K_OBJ;
          for (int32_t i = 0; i < n_obj; ++i) {
            if ((a->mask >> i) & 1u) { r.value = i; r.mask = (1u << i); break; }
          }
          break;
        }
        case FN_RELATE: {
          // Python looks the subject up in a dict with [] default, and bools
          // hash as ints — any integer-like kind is accepted, out-of-range
          // subjects yield the empty set.
          const bool idx_like =
              a && (a->kind == K_OBJ || a->kind == K_INT || a->kind == K_BOOL);
          if (!idx_like) { error = true; break; }
          r.kind = K_SET;
          r.mask = 0;
          if (a->value >= 0 && a->value < n_obj) {
            const int32_t* offs = rel_offsets + side_value * (n_obj + 1);
            for (int32_t j = offs[a->value]; j < offs[a->value + 1]; ++j) {
              r.mask |= (1u << rel_values[j]);
            }
          }
          break;
        }
        case FN_UNION:
        case FN_INTERSECT: {
          if (!a || !b || a->kind != K_SET || b->kind != K_SET) { error = true; break; }
          r.kind = K_SET;
          r.mask = fn == FN_UNION ? (a->mask | b->mask) : (a->mask & b->mask);
          break;
        }
        case FN_COUNT: {
          if (!a || a->kind != K_SET) { error = true; break; }
          r.kind = K_INT;
          r.value = popcount32(a->mask);
          break;
        }
        case FN_EXIST: {
          if (!a || a->kind != K_SET) { error = true; break; }
          r.kind = K_BOOL;
          r.value = a->mask != 0 ? 1 : 0;
          break;
        }
        case FN_QUERY: {
          const bool idx_like =
              a && (a->kind == K_OBJ || a->kind == K_INT || a->kind == K_BOOL);
          if (!idx_like) { error = true; break; }
          int32_t obj = a->value;
          if (obj < 0) obj += n_obj;  // Python negative indexing
          if (obj < 0 || obj >= n_obj) { error = true; break; }
          Value q = *a; q.value = obj; a = &q;
          r.kind = K_ATTR;
          // globally-unique value code (attr * 8 + local code) so that
          // cross-attribute equality is False, matching Python string compare
          r.value = side_attr * 8 + attrs[a->value * 4 + side_attr];
          break;
        }
        case FN_EQUAL_ATTR:
        case FN_EQUAL_INT:
        case FN_EQUAL_OBJECT: {
          if (!a || !b) { error = true; break; }
          r.kind = K_BOOL;
          // Python == semantics: bool and int are numerically comparable
          // (True == 1); sets compare by content; other kind mixes are False.
          const bool a_num =
              a->kind == K_INT || a->kind == K_BOOL || a->kind == K_OBJ;
          const bool b_num =
              b->kind == K_INT || b->kind == K_BOOL || b->kind == K_OBJ;
          if (a->kind == K_SET && b->kind == K_SET) {
            r.value = a->mask == b->mask ? 1 : 0;
          } else if (a_num && b_num) {
            r.value = a->value == b->value ? 1 : 0;
          } else {
            r.value = (a->kind == b->kind && a->value == b->value) ? 1 : 0;
          }
          break;
        }
        case FN_LESS:
        case FN_GREATER: {
          // Python: ints and bools are ordered numerically (True == 1)
          const bool a_num =
              a && (a->kind == K_INT || a->kind == K_BOOL || a->kind == K_OBJ);
          const bool b_num =
              b && (b->kind == K_INT || b->kind == K_BOOL || b->kind == K_OBJ);
          if (!a_num || !b_num) { error = true; break; }
          r.kind = K_BOOL;
          r.value = fn == FN_LESS ? (a->value < b->value) : (a->value > b->value);
          break;
        }
        case FN_SAME: {
          const bool idx_like =
              a && (a->kind == K_OBJ || a->kind == K_INT || a->kind == K_BOOL);
          if (!idx_like) { error = true; break; }
          r.kind = K_SET;
          r.mask = 0;
          if (a->value < 0 || a->value >= n_obj) break;  // dict .get default
          const int32_t v = attrs[a->value * 4 + side_attr];
          for (int32_t i = 0; i < n_obj; ++i) {
            if (i != a->value && attrs[i * 4 + side_attr] == v) r.mask |= (1u << i);
          }
          break;
        }
        default:
          error = true;
      }

      if (error) {
        r.kind = K_POISONED;
        poisoned = true;
      } else if (r.kind == K_INVALID) {
        poisoned = true;  // later steps read a truncated prefix
      }
    }

    vals[s] = r;
    out[s * 3 + 0] = r.kind;
    out[s * 3 + 1] = r.value;
    out[s * 3 + 2] = static_cast<int32_t>(r.mask);
  }
  return 0;
}

// Batched execution: programs are concatenated; per-program offsets given.
int clevr_execute_batch(
    int32_t n_obj,
    const int32_t* attrs,
    const int32_t* rel_offsets,
    const int32_t* rel_values,
    int32_t n_programs,
    const int32_t* prog_offsets,   // [n_programs + 1], in steps
    const int32_t* steps,          // [total_steps * 5]
    int32_t* out                   // [total_steps * 3]
) {
  for (int32_t p = 0; p < n_programs; ++p) {
    const int32_t begin = prog_offsets[p];
    const int32_t end = prog_offsets[p + 1];
    int rc = clevr_execute(n_obj, attrs, rel_offsets, rel_values, end - begin,
                           steps + begin * 5, out + begin * 3);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
