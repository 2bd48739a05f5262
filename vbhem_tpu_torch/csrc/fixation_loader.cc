// Native CSV fixation-table loader of vbhem_tpu_torch: this package's own
// copy of the JAX package's loader, with the same C ABI.
//
// Parses a CSV with columns SubjectID, TrialID, FixX, FixY, [FixD]
// (case-insensitive, any column order; `src/util/read_xls_fixations.m`)
// and packs the ragged per-(subject, trial) sequences into the dense
// padded layout the engines consume ([N, T_max, D] + lengths), in one
// pass and without per-row Python overhead.  Host code only: it is built
// by the host C++ compiler, not nvcc (vbhem_tpu_torch/ops/_build.py,
// `build_host`), at first use, and bound with ctypes by
// vbhem_tpu_torch/utils/native_io.py.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Trial {
  std::vector<double> values;  // flattened [t, dim]
};

struct Subject {
  std::string name;
  std::vector<std::string> trial_order;
  std::unordered_map<std::string, Trial> trials;
};

struct Dataset {
  std::vector<Subject> subjects;
  std::unordered_map<std::string, size_t> subject_index;
  int dim = 2;
  std::string error;
};

std::string lower(std::string s) {
  for (auto& c : s) c = static_cast<char>(std::tolower(c));
  return s;
}

std::string strip(const std::string& s) {
  size_t b = s.find_first_not_of(" \t\r\n\"");
  if (b == std::string::npos) return "";
  size_t e = s.find_last_not_of(" \t\r\n\"");
  return s.substr(b, e - b + 1);
}

std::vector<std::string> split_csv_line(const std::string& line) {
  std::vector<std::string> out;
  std::string cur;
  bool quoted = false;
  for (char c : line) {
    if (c == '"') {
      quoted = !quoted;
    } else if (c == ',' && !quoted) {
      out.push_back(cur);
      cur.clear();
    } else {
      cur.push_back(c);
    }
  }
  out.push_back(cur);
  return out;
}

}  // namespace

extern "C" {

// Parse the file; returns an opaque handle (nullptr on hard failure).
void* vbhem_parse_fixations(const char* path) {
  auto* ds = new Dataset();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    ds->error = "cannot open file";
    return ds;
  }

  std::string content;
  {
    char buf[1 << 16];
    size_t n;
    while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0)
      content.append(buf, n);
    std::fclose(f);
  }

  int subj_col = -1, trial_col = -1, x_col = -1, y_col = -1, d_col = -1;
  size_t pos = 0;
  bool header_done = false;
  while (pos < content.size()) {
    size_t nl = content.find('\n', pos);
    if (nl == std::string::npos) nl = content.size();
    std::string line = content.substr(pos, nl - pos);
    pos = nl + 1;
    if (strip(line).empty()) continue;

    std::vector<std::string> cells = split_csv_line(line);
    if (!header_done) {
      // header discovery (read_xls_fixations.m:53-80): find the row
      // containing the required column names
      for (size_t i = 0; i < cells.size(); ++i) {
        std::string c = lower(strip(cells[i]));
        if (c == "subjectid") subj_col = static_cast<int>(i);
        else if (c == "trialid") trial_col = static_cast<int>(i);
        else if (c == "fixx") x_col = static_cast<int>(i);
        else if (c == "fixy") y_col = static_cast<int>(i);
        else if (c == "fixd") d_col = static_cast<int>(i);
      }
      if (subj_col >= 0 && trial_col >= 0 && x_col >= 0 && y_col >= 0) {
        header_done = true;
        ds->dim = (d_col >= 0) ? 3 : 2;
      }
      continue;
    }

    int needed = std::max(std::max(subj_col, trial_col),
                          std::max(x_col, std::max(y_col, d_col)));
    if (static_cast<int>(cells.size()) <= needed) continue;
    std::string subj = strip(cells[subj_col]);
    std::string trial = strip(cells[trial_col]);
    if (subj.empty() || trial.empty()) continue;
    char* endp = nullptr;
    std::string xs = strip(cells[x_col]), ys = strip(cells[y_col]);
    double x = std::strtod(xs.c_str(), &endp);
    if (endp == xs.c_str()) continue;
    double y = std::strtod(ys.c_str(), &endp);
    if (endp == ys.c_str()) continue;

    auto it = ds->subject_index.find(subj);
    if (it == ds->subject_index.end()) {
      it = ds->subject_index.emplace(subj, ds->subjects.size()).first;
      ds->subjects.push_back(Subject{subj, {}, {}});
    }
    Subject& s = ds->subjects[it->second];
    auto tit = s.trials.find(trial);
    if (tit == s.trials.end()) {
      tit = s.trials.emplace(trial, Trial{}).first;
      s.trial_order.push_back(trial);
    }
    tit->second.values.push_back(x);
    tit->second.values.push_back(y);
    if (ds->dim == 3) {
      std::string dsv = strip(cells[d_col]);
      double dur = std::strtod(dsv.c_str(), &endp);
      tit->second.values.push_back(endp == dsv.c_str() ? 0.0 : dur);
    }
  }
  if (!header_done)
    ds->error = "no header row with SubjectID/TrialID/FixX/FixY found";
  return ds;
}

const char* vbhem_error(void* handle) {
  auto* ds = static_cast<Dataset*>(handle);
  return ds->error.c_str();
}

int64_t vbhem_num_subjects(void* handle) {
  return static_cast<Dataset*>(handle)->subjects.size();
}

int64_t vbhem_dim(void* handle) {
  return static_cast<Dataset*>(handle)->dim;
}

const char* vbhem_subject_name(void* handle, int64_t i) {
  return static_cast<Dataset*>(handle)->subjects[i].name.c_str();
}

int64_t vbhem_num_trials(void* handle, int64_t i) {
  return static_cast<Dataset*>(handle)->subjects[i].trial_order.size();
}

// Longest trial of subject i (its T_max).
int64_t vbhem_max_len(void* handle, int64_t i) {
  auto& s = static_cast<Dataset*>(handle)->subjects[i];
  auto* ds = static_cast<Dataset*>(handle);
  size_t mx = 0;
  for (auto& name : s.trial_order) {
    size_t t = s.trials[name].values.size() / ds->dim;
    if (t > mx) mx = t;
  }
  return static_cast<int64_t>(mx);
}

// Fill caller-allocated buffers: data [n_trials * t_max * dim] (zero
// padded), lengths [n_trials].  Returns 0 on success.
int vbhem_fill_subject(void* handle, int64_t i, double* data,
                       int64_t* lengths, int64_t t_max) {
  auto* ds = static_cast<Dataset*>(handle);
  if (i < 0 || i >= static_cast<int64_t>(ds->subjects.size())) return 1;
  Subject& s = ds->subjects[i];
  const int dim = ds->dim;
  std::memset(data, 0,
              sizeof(double) * s.trial_order.size() * t_max * dim);
  for (size_t n = 0; n < s.trial_order.size(); ++n) {
    const Trial& tr = s.trials[s.trial_order[n]];
    int64_t t = static_cast<int64_t>(tr.values.size()) / dim;
    if (t > t_max) t = t_max;
    lengths[n] = t;
    std::memcpy(data + n * t_max * dim, tr.values.data(),
                sizeof(double) * t * dim);
  }
  return 0;
}

void vbhem_free(void* handle) { delete static_cast<Dataset*>(handle); }

}  // extern "C"
