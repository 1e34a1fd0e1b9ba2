/* sample_loader.c -- native bulk sample-file parser.
 *
 * The reference reads every sample file with a C text parser
 * (_NN(read,sample), src/libhpnn.c:1070-1145 of the reference); the
 * port bulk-loads whole corpora (60k files for MNIST), where
 * a per-token Python float() loop is the bottleneck.  This loader is the
 * native fast path behind hpnn_tpu_torch.io.samples: it parses the common
 * well-formed shape
 *
 *     [input] N
 *     v1 ... vN            (one line, like the reference reads it)
 *     [output] M
 *     t1 ... tM
 *
 * and DECLINES (rc -2) on anything unusual -- missing/zero counts,
 * over-capacity vectors, tokens strtod cannot fully consume, fewer than
 * N values on the single line after the header (the reference reads
 * values from ONE line, zero-filling via strtod semantics -- only the
 * Python parser replicates that) -- so the Python parser re-reads those
 * files and keeps its reference-exact quirk behavior.  A decline is
 * always correct, never an error.
 *
 * No CPython dependency: plain C, called through ctypes.  The port's
 * ops/build.py compiles it with the host C compiler at first use.
 */
#include <ctype.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define RC_OK 0
#define RC_OPEN_FAIL (-1)
#define RC_FALLBACK (-2)

/* parse "<count>" after a "[input" / "[output" keyword; returns count or
 * -1 unless the whole first token is digits.  The reference (and the
 * Python parser) skip ONE char after the keyword UNCONDITIONALLY
 * (ptr += len("[input")+1), so "[input42" reads count 2 there -- mirror
 * that exactly, and still require a full-digit token ("4.5"/"2abc"
 * DECLINE to the Python parser, which truncates like strtoull). */
static long parse_count(const char *after)
{
    const char *p;
    char *end;
    long n;
    if (*after == '\0') return -1;
    after++; /* skip one char after the keyword, whatever it is */
    while (*after && isspace((unsigned char)*after)) after++;
    if (!isdigit((unsigned char)*after)) return -1;
    for (p = after; *p && !isspace((unsigned char)*p); p++)
        if (!isdigit((unsigned char)*p)) return -1;
    n = strtol(after, &end, 10);
    if (n <= 0) return -1;
    return n;
}

/* read `n` doubles from the ONE line following the header (the
 * reference's READLINE + n GET_DOUBLEs, libhpnn.c:1102-1111); every
 * token must be fully consumed by strtod and all n must be present on
 * that line.  Returns 0 on success, RC_FALLBACK otherwise. */
static int read_values(FILE *fp, char **line, size_t *cap, double *buf,
                       long n)
{
    long got = 0;
    ssize_t len = getline(line, cap, fp);
    char *p;
    if (len < 0) return RC_FALLBACK;
    p = *line;
    while (got < n) {
        while (*p && isspace((unsigned char)*p)) p++;
        if (*p == '\0') return RC_FALLBACK; /* short line: Python path */
        {
            char *tok_end = p;
            char saved, *end;
            double v;
            while (*tok_end && !isspace((unsigned char)*tok_end)) tok_end++;
            saved = *tok_end;
            *tok_end = '\0';
            /* strtod accepts hex floats and nan(chars) whose exact
             * semantics live in the Python parser -- decline those */
            for (char *q = p; q < tok_end; q++) {
                if (*q == 'x' || *q == 'X' || *q == '(') {
                    *tok_end = saved;
                    return RC_FALLBACK;
                }
            }
            v = strtod(p, &end);
            if (end != tok_end || end == p) return RC_FALLBACK;
            *tok_end = saved;
            buf[got++] = v;
            p = tok_end;
        }
    }
    /* the reference re-checks the VALUES line for section keywords in
     * the same iteration -- a '[' anywhere in the unconsumed remainder
     * could be one; decline so the Python parser handles the flow */
    while (*p) {
        if (*p == '[') return RC_FALLBACK;
        p++;
    }
    return RC_OK;
}

/* Parse one sample file.  in_buf/out_buf have capacity in_cap/out_cap;
 * on RC_OK, n_in / n_out carry the header counts (<= caps). */
int hpnn_read_sample(const char *path, double *in_buf, int in_cap,
                     int *n_in, double *out_buf, int out_cap, int *n_out)
{
    FILE *fp = fopen(path, "r");
    char *line = NULL;
    size_t cap = 0;
    int have_in = 0, have_out = 0;
    int rc = RC_OK;

    if (fp == NULL) return RC_OPEN_FAIL;
    *n_in = 0;
    *n_out = 0;
    while (rc == RC_OK) {
        ssize_t len = getline(&line, &cap, fp);
        const char *key;
        if (len < 0) break;
        if ((key = strstr(line, "[input")) != NULL) {
            long n = parse_count(key + 6);
            if (n < 0 || n > in_cap) { rc = RC_FALLBACK; break; }
            rc = read_values(fp, &line, &cap, in_buf, n);
            if (rc == RC_OK) { *n_in = (int)n; have_in = 1; }
        } else if ((key = strstr(line, "[output")) != NULL) {
            long n = parse_count(key + 7);
            if (n < 0 || n > out_cap) { rc = RC_FALLBACK; break; }
            rc = read_values(fp, &line, &cap, out_buf, n);
            if (rc == RC_OK) { *n_out = (int)n; have_out = 1; }
        }
    }
    free(line);
    fclose(fp);
    if (rc != RC_OK) return rc;
    if (!have_in || !have_out) return RC_FALLBACK;
    return RC_OK;
}
