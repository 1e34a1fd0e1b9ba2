/* hpnn_shim.c -- serves the FULL libhpnn.h C API from the PyTorch/CUDA
 * port (hpnn_tpu_torch): the JAX package's native/hpnn_shim.c with its
 * modules replaced by the port's.
 *
 * The compute lives in the port (its hand-written CUDA kernels on the
 * card), so this layer's job is dispatch: an embedded CPython interpreter
 * loads hpnn_tpu_torch and forwards each _NN call.  Every entry point of
 * the reference header (include/libhpnn.h:123-228) is implemented with the
 * reference's exact prototype, so C programs of the public API compile
 * and link unmodified.  The device is HPNN_DEVICE's (default cuda; the
 * shim's init_all).
 *
 * Embedding: hpnn_tpu_torch/ops/build.py compiles this file with the
 * building interpreter's embedding flags and bakes in HPNN_PYROOT (the
 * checkout), HPNN_PYEXE (that interpreter: a venv's python makes the
 * embedded one find the venv) and HPNN_PYSITE (its site-packages, added
 * to sys.path in any case, so torch imports).  Inside a running Python
 * (ctypes.PyDLL, which holds the interpreter lock across each call) the
 * live interpreter is used as it is.
 *
 * Handle model: nn_def is the reference's concrete struct.  The C fields
 * are a live mirror of the Python NNDef (synced on load/set/train); the
 * Python object itself is kept in a side table keyed by the nn_def
 * pointer, and conf->kernel carries only the "a kernel exists" flag the
 * reference semantics require (non-NULL iff the engine holds weights).
 *
 * Thread-safety: calls must come from one thread (the reference library
 * is equally single-threaded at the API level, libhpnn.c:60).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include <libhpnn.h>

#ifndef HPNN_PYROOT
#define HPNN_PYROOT "."
#endif
#ifndef HPNN_PYSITE
#define HPNN_PYSITE ""
#endif

static PyObject *mod_api = NULL;      /* hpnn_tpu_torch.api */
static PyObject *mod_log = NULL;      /* hpnn_tpu_torch.utils.nn_log */
static PyObject *mod_shim = NULL;     /* hpnn_tpu_torch.shim (+ runtime) */

static nn_runtime shim_runtime; /* C mirror served by _NN(return,cudas) etc. */

/* start the interpreter of the building Python (its venv, if any) */
static int start_python(void)
{
    PyConfig config;
    PyStatus status;
    PyConfig_InitPythonConfig(&config);
    config.install_signal_handlers = 0;
#ifdef HPNN_PYEXE
    status = PyConfig_SetBytesString(&config, &config.program_name,
                                     HPNN_PYEXE);
    if (PyStatus_Exception(status)) goto fail;
#endif
    status = Py_InitializeFromConfig(&config);
    if (PyStatus_Exception(status)) goto fail;
    PyConfig_Clear(&config);
    return 0;
fail:
    PyConfig_Clear(&config);
    fprintf(stderr, "libhpnn_tpu_torch: cannot start Python: %s\n",
            status.err_msg ? status.err_msg : "unknown error");
    return -1;
}

/* sys.path: the building interpreter's site dirs (.pth files honored),
 * then the checkout in front */
static void add_paths(const char *root)
{
    PyObject *site, *sys_path, *p, *r;
    char *dirs, *dir, *save = NULL;
    site = PyImport_ImportModule("site");
    dirs = strdup(HPNN_PYSITE);
    if (site != NULL && dirs != NULL) {
        for (dir = strtok_r(dirs, ":", &save); dir != NULL;
             dir = strtok_r(NULL, ":", &save)) {
            r = PyObject_CallMethod(site, "addsitedir", "s", dir);
            if (r == NULL) PyErr_Print();
            Py_XDECREF(r);
        }
    } else {
        PyErr_Clear();
    }
    free(dirs);
    Py_XDECREF(site);
    sys_path = PySys_GetObject("path"); /* borrowed */
    if (sys_path != NULL) {
        p = PyUnicode_FromString(root);
        if (p != NULL) {
            PyList_Insert(sys_path, 0, p);
            Py_DECREF(p);
        }
    }
}

static int ensure_python(void)
{
    const char *root;
    if (mod_api != NULL) return 0;
    root = getenv("HPNN_PYROOT");
    if (root == NULL) root = HPNN_PYROOT;
    if (!Py_IsInitialized()) {
        if (start_python() != 0) return -1;
        add_paths(root);
    }
    mod_api = PyImport_ImportModule("hpnn_tpu_torch.api");
    mod_log = PyImport_ImportModule("hpnn_tpu_torch.utils.nn_log");
    mod_shim = PyImport_ImportModule("hpnn_tpu_torch.shim");
    if (mod_api == NULL || mod_log == NULL || mod_shim == NULL) {
        PyErr_Print();
        fprintf(stderr, "libhpnn_tpu_torch: failed to import "
                "hpnn_tpu_torch from %s\n", root);
        Py_CLEAR(mod_api);
        Py_CLEAR(mod_log);
        Py_CLEAR(mod_shim);
        return -1;
    }
    return 0;
}

/* call mod.fn(args); returns new ref or NULL (error printed) */
static PyObject *call(PyObject *mod, const char *fn, PyObject *args)
{
    PyObject *f, *r = NULL;
    f = PyObject_GetAttrString(mod, fn);
    if (f != NULL) {
        r = PyObject_CallObject(f, args);
        Py_DECREF(f);
    }
    if (r == NULL) PyErr_Print();
    Py_XDECREF(args);
    return r;
}

static long call_long(PyObject *mod, const char *fn, PyObject *args,
                      long fallback)
{
    long v = fallback;
    PyObject *r = call(mod, fn, args);
    if (r != NULL) {
        if (r == Py_None) v = fallback;
        else if (PyBool_Check(r)) v = (r == Py_True);
        else v = PyLong_AsLong(r);
        Py_DECREF(r);
        if (PyErr_Occurred()) { PyErr_Print(); v = fallback; }
    }
    return v;
}

/* ---- nn_def* -> PyObject* side table ---------------------------------- */

struct handle_slot { nn_def *key; PyObject *obj; };
static struct handle_slot *handles = NULL;
static size_t n_handles = 0, cap_handles = 0;

static PyObject *table_get(nn_def *conf)
{
    size_t i;
    for (i = 0; i < n_handles; i++)
        if (handles[i].key == conf) return handles[i].obj; /* borrowed */
    return NULL;
}

static void table_set(nn_def *conf, PyObject *obj) /* steals obj */
{
    size_t i;
    for (i = 0; i < n_handles; i++) {
        if (handles[i].key == conf) {
            Py_XDECREF(handles[i].obj);
            handles[i].obj = obj;
            return;
        }
    }
    if (n_handles == cap_handles) {
        size_t nc = cap_handles ? cap_handles * 2 : 16;
        struct handle_slot *nh =
            realloc(handles, nc * sizeof(*handles));
        if (nh == NULL) { Py_XDECREF(obj); return; }
        handles = nh;
        cap_handles = nc;
    }
    handles[n_handles].key = conf;
    handles[n_handles].obj = obj;
    n_handles++;
}

static void table_del(nn_def *conf)
{
    size_t i;
    for (i = 0; i < n_handles; i++) {
        if (handles[i].key == conf) {
            Py_XDECREF(handles[i].obj);
            handles[i] = handles[n_handles - 1];
            n_handles--;
            return;
        }
    }
}

/* swap a mirror string ONLY when the value changed: pointers handed out
 * by _NN(return,name) etc. must stay valid across train/load calls, as
 * they do in the reference (libhpnn.c:580 returns the internal pointer
 * and never reallocates it during training) */
static void update_str(CHAR **field, const char *value)
{
    if (*field == NULL && value == NULL) return;
    if (*field != NULL && value != NULL && strcmp(*field, value) == 0)
        return;
    FREE(*field);
    STRDUP(value, *field);
}

/* pull the Python NNDef's conf into the C mirror fields */
static void sync_from_py(nn_def *conf)
{
    PyObject *obj = table_get(conf), *t, *k;
    const char *s;
    if (obj == NULL) return;
    t = call(mod_shim, "conf_as_tuple", Py_BuildValue("(O)", obj));
    if (t == NULL || !PyTuple_Check(t) || PyTuple_Size(t) != 8) {
        Py_XDECREF(t);
        return;
    }
    s = PyTuple_GetItem(t, 0) == Py_None ? NULL
        : PyUnicode_AsUTF8(PyTuple_GetItem(t, 0));
    update_str(&conf->name, s);
    conf->type = (nn_type)PyLong_AsLong(PyTuple_GetItem(t, 1));
    conf->need_init = (BOOL)PyLong_AsLong(PyTuple_GetItem(t, 2));
    conf->seed = (UINT)PyLong_AsLong(PyTuple_GetItem(t, 3));
    s = PyTuple_GetItem(t, 4) == Py_None ? NULL
        : PyUnicode_AsUTF8(PyTuple_GetItem(t, 4));
    update_str(&conf->f_kernel, s);
    conf->train = (nn_train)PyLong_AsLong(PyTuple_GetItem(t, 5));
    s = PyTuple_GetItem(t, 6) == Py_None ? NULL
        : PyUnicode_AsUTF8(PyTuple_GetItem(t, 6));
    update_str(&conf->samples, s);
    s = PyTuple_GetItem(t, 7) == Py_None ? NULL
        : PyUnicode_AsUTF8(PyTuple_GetItem(t, 7));
    update_str(&conf->tests, s);
    Py_DECREF(t);
    /* kernel flag: non-NULL iff the Python side holds weights */
    k = PyObject_GetAttrString(obj, "kernel");
    if (k != NULL) {
        conf->kernel = (k == Py_None) ? NULL : (void *)conf;
        Py_DECREF(k);
    } else {
        PyErr_Clear();
    }
    conf->rr = &shim_runtime;
}

/* lazily create the Python NNDef for a C-initialized conf and push the
 * current C mirror into it */
static PyObject *ensure_handle(nn_def *conf)
{
    PyObject *obj;
    if (ensure_python() != 0) return NULL;
    obj = table_get(conf);
    if (obj != NULL) return obj;
    obj = call(mod_shim, "new_nndef", NULL);
    if (obj == NULL) return NULL;
    table_set(conf, obj); /* steals */
    if (conf->name != NULL)
        Py_XDECREF(call(mod_shim, "conf_set",
                        Py_BuildValue("(Oss)", obj, "name", conf->name)));
    Py_XDECREF(call(mod_shim, "conf_set",
                    Py_BuildValue("(Osi)", obj, "type", (int)conf->type)));
    Py_XDECREF(call(mod_shim, "conf_set",
                    Py_BuildValue("(Osi)", obj, "need_init",
                                  (int)conf->need_init)));
    Py_XDECREF(call(mod_shim, "conf_set",
                    Py_BuildValue("(OsI)", obj, "seed", conf->seed)));
    if (conf->f_kernel != NULL)
        Py_XDECREF(call(mod_shim, "conf_set",
                        Py_BuildValue("(Oss)", obj, "f_kernel",
                                      conf->f_kernel)));
    Py_XDECREF(call(mod_shim, "conf_set",
                    Py_BuildValue("(Osi)", obj, "train", (int)conf->train)));
    if (conf->samples != NULL)
        Py_XDECREF(call(mod_shim, "conf_set",
                        Py_BuildValue("(Oss)", obj, "samples",
                                      conf->samples)));
    if (conf->tests != NULL)
        Py_XDECREF(call(mod_shim, "conf_set",
                        Py_BuildValue("(Oss)", obj, "tests", conf->tests)));
    return obj;
}

/* push one C-side field change into the Python conf (string value) */
static void push_str(nn_def *conf, const char *key, const char *value)
{
    PyObject *obj = ensure_handle(conf);
    if (obj == NULL) return;
    if (value == NULL)
        Py_XDECREF(call(mod_shim, "conf_set",
                        Py_BuildValue("(OsO)", obj, key, Py_None)));
    else
        Py_XDECREF(call(mod_shim, "conf_set",
                        Py_BuildValue("(Oss)", obj, key, value)));
}

static void push_int(nn_def *conf, const char *key, long value)
{
    PyObject *obj = ensure_handle(conf);
    if (obj == NULL) return;
    Py_XDECREF(call(mod_shim, "conf_set",
                    Py_BuildValue("(Osl)", obj, key, value)));
}

/* wrap a C FILE* as a Python text file over a dup'd fd; closing the
 * Python file closes only the dup */
static PyObject *pyfile_from(FILE *out)
{
    PyObject *os_mod, *pyf;
    int fd;
    fflush(out);
    fd = dup(fileno(out));
    if (fd < 0) return NULL;
    os_mod = PyImport_ImportModule("os");
    if (os_mod == NULL) { PyErr_Print(); close(fd); return NULL; }
    pyf = PyObject_CallMethod(os_mod, "fdopen", "is", fd, "w");
    Py_DECREF(os_mod);
    if (pyf == NULL) { PyErr_Print(); close(fd); return NULL; }
    return pyf;
}

/* ---- verbosity / runtime ---------------------------------------------- */

int nn_init_all(UINT init_verbose)
{
    if (ensure_python() != 0) return -1;
    return (int)call_long(mod_shim, "init_all",
                          Py_BuildValue("(I)", init_verbose), -1);
}

int nn_deinit_all(void)
{
    if (mod_api == NULL) return 0;
    return (int)call_long(mod_shim, "deinit_all", NULL, -1);
}

void nn_inc_verbose(void)
{
    if (ensure_python() != 0) return;
    Py_XDECREF(call(mod_log, "inc_verbosity", NULL));
}

void nn_dec_verbose(void)
{
    if (ensure_python() != 0) return;
    Py_XDECREF(call(mod_log, "dec_verbosity", NULL));
}

void nn_set_verbose(SHORT verbosity)
{
    if (ensure_python() != 0) return;
    Py_XDECREF(call(mod_log, "set_verbosity",
                    Py_BuildValue("(i)", (int)verbosity)));
}

void nn_get_verbose(SHORT *verbosity)
{
    if (verbosity == NULL) return;
    *verbosity = nn_return_verbose();
}

SHORT nn_return_verbose(void)
{
    if (ensure_python() != 0) return 0;
    return (SHORT)call_long(mod_log, "get_verbosity", NULL, 0);
}

void nn_toggle_dry(void)
{
    if (ensure_python() != 0) return;
    Py_XDECREF(call(mod_shim, "toggle_dry", NULL));
}

void nn_get_capabilities(nn_cap *capabilities)
{
    if (capabilities == NULL) return;
    *capabilities = nn_return_capabilities();
}

void nn_unset_capability(nn_cap capability)
{
    if (ensure_python() != 0) return;
    Py_XDECREF(call(mod_shim, "unset_capability",
                    Py_BuildValue("(i)", (int)capability)));
}

nn_cap nn_return_capabilities(void)
{
    if (ensure_python() != 0) return NN_CAP_NONE;
    return (nn_cap)call_long(mod_shim, "return_capabilities", NULL, 0);
}

BOOL nn_init_OMP(void)
{
    if (ensure_python() != 0) return FALSE;
    return (BOOL)call_long(mod_shim, "init_omp", NULL, 0);
}

BOOL nn_init_MPI(void)
{
    if (ensure_python() != 0) return FALSE;
    return (BOOL)call_long(mod_shim, "init_mpi", NULL, 0);
}

BOOL nn_init_CUDA(void)
{
    if (ensure_python() != 0) return FALSE;
    return (BOOL)call_long(mod_shim, "init_cuda", NULL, 0);
}

BOOL nn_init_BLAS(void)
{
    if (ensure_python() != 0) return FALSE;
    return (BOOL)call_long(mod_shim, "init_blas", NULL, 0);
}

BOOL nn_deinit_OMP(void)
{
    if (mod_shim == NULL) return TRUE;
    return (BOOL)call_long(mod_shim, "deinit_omp", NULL, 1);
}

BOOL nn_deinit_MPI(void)
{
    if (mod_shim == NULL) return TRUE;
    return (BOOL)call_long(mod_shim, "deinit_mpi", NULL, 1);
}

BOOL nn_deinit_CUDA(void)
{
    if (mod_shim == NULL) return TRUE;
    return (BOOL)call_long(mod_shim, "deinit_cuda", NULL, 1);
}

BOOL nn_deinit_BLAS(void)
{
    if (mod_shim == NULL) return TRUE;
    return (BOOL)call_long(mod_shim, "deinit_blas", NULL, 1);
}

/* ---- set/get lib parameters ------------------------------------------- */

BOOL nn_set_omp_threads(UINT n)
{
    if (ensure_python() != 0) return FALSE;
    return (BOOL)call_long(mod_shim, "set_omp_threads",
                           Py_BuildValue("(I)", n), 0);
}

BOOL nn_get_omp_threads(UINT *n_threads)
{
    if (n_threads == NULL || ensure_python() != 0) return FALSE;
    *n_threads = (UINT)call_long(mod_shim, "get_omp_threads", NULL, 1);
    return TRUE;
}

int nn_return_omp_threads(void)
{
    if (ensure_python() != 0) return 1;
    return (int)call_long(mod_shim, "get_omp_threads", NULL, 1);
}

BOOL nn_set_mpi_tasks(UINT n_tasks)
{
    if (ensure_python() != 0) return FALSE;
    return (BOOL)call_long(mod_shim, "set_mpi_tasks",
                           Py_BuildValue("(I)", n_tasks), 0);
}

BOOL nn_get_mpi_tasks(UINT *n_tasks)
{
    if (n_tasks == NULL || ensure_python() != 0) return FALSE;
    *n_tasks = (UINT)call_long(mod_shim, "get_mpi_tasks", NULL, 1);
    return TRUE;
}

BOOL nn_get_curr_mpi_task(UINT *task)
{
    if (task == NULL || ensure_python() != 0) return FALSE;
    *task = (UINT)call_long(mod_shim, "get_curr_mpi_task", NULL, 0);
    return TRUE;
}

BOOL nn_set_n_gpu(UINT n_gpu)
{
    if (ensure_python() != 0) return FALSE;
    return (BOOL)call_long(mod_shim, "set_n_gpu",
                           Py_BuildValue("(I)", n_gpu), 0);
}

BOOL nn_get_n_gpu(UINT *n_gpu)
{
    if (n_gpu == NULL || ensure_python() != 0) return FALSE;
    *n_gpu = (UINT)call_long(mod_shim, "get_n_gpu", NULL, 1);
    return TRUE;
}

BOOL nn_set_cuda_streams(UINT n)
{
    if (ensure_python() != 0) return FALSE;
    return (BOOL)call_long(mod_shim, "set_cuda_streams",
                           Py_BuildValue("(I)", n), 0);
}

BOOL nn_get_cuda_streams(UINT *n_streams)
{
    if (n_streams == NULL || ensure_python() != 0) return FALSE;
    *n_streams = (UINT)call_long(mod_shim, "get_cuda_streams", NULL, 1);
    return TRUE;
}

BOOL nn_set_omp_blas(UINT n)
{
    if (ensure_python() != 0) return FALSE;
    return (BOOL)call_long(mod_shim, "set_omp_blas",
                           Py_BuildValue("(I)", n), 0);
}

BOOL nn_get_omp_blas(UINT *n_blas)
{
    if (n_blas == NULL || ensure_python() != 0) return FALSE;
    *n_blas = (UINT)call_long(mod_shim, "get_omp_blas", NULL, 1);
    return TRUE;
}

cudastreams *nn_return_cudas(void)
{
    if (ensure_python() == 0) {
        shim_runtime.cudas.n_gpu =
            (UINT)call_long(mod_shim, "get_n_devices", NULL, 1);
        shim_runtime.cudas.cuda_n_streams =
            (UINT)call_long(mod_shim, "get_cuda_streams", NULL, 1);
        shim_runtime.cudas.cuda_handle = NULL;
        shim_runtime.cudas.cuda_streams = NULL;
        /* the cards of a host reach each other (NVLink) */
        shim_runtime.cudas.mem_model = CUDAS_MEM_P2P;
    }
    return &shim_runtime.cudas;
}

/* ---- configuration ---------------------------------------------------- */

void nn_init_conf(nn_def *conf)
{
    if (conf == NULL) return;
    conf->rr = &shim_runtime;
    conf->name = NULL;
    conf->type = NN_TYPE_UKN;
    conf->need_init = FALSE;
    conf->seed = 0;
    conf->kernel = NULL;
    conf->f_kernel = NULL;
    conf->train = NN_TRAIN_UKN;
    conf->samples = NULL;
    conf->tests = NULL;
}

void nn_deinit_conf(nn_def *conf)
{
    if (conf == NULL) return;
    table_del(conf);
    conf->rr = NULL;
    FREE(conf->name);
    conf->type = NN_TYPE_UKN;
    conf->need_init = FALSE;
    conf->seed = 0;
    conf->kernel = NULL;
    FREE(conf->f_kernel);
    conf->train = NN_TRAIN_UKN;
    FREE(conf->samples);
    FREE(conf->tests);
}

void nn_set_name(nn_def *conf, const CHAR *name)
{
    if (conf == NULL) return;
    FREE(conf->name);
    STRDUP(name, conf->name);
    push_str(conf, "name", conf->name);
}

void nn_get_name(nn_def *conf, CHAR **name)
{
    if (conf == NULL || name == NULL) return;
    STRDUP(conf->name, *name); /* caller frees, as the reference */
}

char *nn_return_name(nn_def *conf)
{
    return conf == NULL ? NULL : conf->name;
}

void nn_set_type(nn_def *conf, nn_type type)
{
    if (conf == NULL) return;
    conf->type = type;
    push_int(conf, "type", (long)type);
}

void nn_get_type(nn_def *conf, nn_type *type)
{
    if (conf == NULL || type == NULL) return;
    *type = conf->type;
}

nn_type nn_return_type(nn_def *conf)
{
    return conf == NULL ? NN_TYPE_UKN : conf->type;
}

void nn_set_need_init(nn_def *conf, BOOL need_init)
{
    if (conf == NULL) return;
    conf->need_init = need_init;
    push_int(conf, "need_init", (long)need_init);
}

void nn_get_need_init(nn_def *conf, BOOL *need_init)
{
    if (conf == NULL || need_init == NULL) return;
    *need_init = conf->need_init;
}

BOOL nn_return_need_init(nn_def *conf)
{
    return conf == NULL ? FALSE : conf->need_init;
}

void nn_set_seed(nn_def *conf, UINT seed)
{
    if (conf == NULL) return;
    conf->seed = seed;
    push_int(conf, "seed", (long)seed);
}

void nn_get_seed(nn_def *conf, UINT *seed)
{
    if (conf == NULL || seed == NULL) return;
    *seed = conf->seed;
}

UINT nn_return_seed(nn_def *conf)
{
    return conf == NULL ? 0 : conf->seed;
}

void nn_set_kernel_filename(nn_def *conf, CHAR *f_kernel)
{
    if (conf == NULL) return;
    FREE(conf->f_kernel);
    STRDUP(f_kernel, conf->f_kernel);
    push_str(conf, "f_kernel", conf->f_kernel);
}

void nn_get_kernel_filename(nn_def *conf, CHAR **f_kernel)
{
    if (conf == NULL || f_kernel == NULL) return;
    STRDUP(conf->f_kernel, *f_kernel);
}

char *nn_return_kernel_filename(nn_def *conf)
{
    return conf == NULL ? NULL : conf->f_kernel;
}

void nn_set_train(nn_def *conf, nn_train train)
{
    if (conf == NULL) return;
    conf->train = train;
    push_int(conf, "train", (long)train);
}

void nn_get_train(nn_def *conf, nn_train *train)
{
    if (conf == NULL || train == NULL) return;
    *train = conf->train;
}

nn_train nn_return_train(nn_def *conf)
{
    return conf == NULL ? NN_TRAIN_UKN : conf->train;
}

void nn_set_samples_directory(nn_def *conf, CHAR *samples)
{
    if (conf == NULL) return;
    FREE(conf->samples);
    STRDUP(samples, conf->samples);
    push_str(conf, "samples", conf->samples);
}

void nn_get_samples_directory(nn_def *conf, CHAR **samples)
{
    if (conf == NULL || samples == NULL) return;
    STRDUP(conf->samples, *samples);
}

char *nn_return_samples_directory(nn_def *conf)
{
    return conf == NULL ? NULL : conf->samples;
}

void nn_set_tests_directory(nn_def *conf, CHAR *tests)
{
    if (conf == NULL) return;
    FREE(conf->tests);
    STRDUP(tests, conf->tests);
    push_str(conf, "tests", conf->tests);
}

void nn_get_tests_directory(nn_def *conf, CHAR **tests)
{
    if (conf == NULL || tests == NULL) return;
    STRDUP(conf->tests, *tests);
}

char *nn_return_tests_directory(nn_def *conf)
{
    return conf == NULL ? NULL : conf->tests;
}

nn_def *nn_load_conf(const CHAR *filename)
{
    PyObject *r;
    nn_def *conf;
    if (ensure_python() != 0) return NULL;
    r = call(mod_api, "configure", Py_BuildValue("(s)", filename));
    if (r == NULL || r == Py_None) {
        Py_XDECREF(r);
        return NULL;
    }
    conf = (nn_def *)malloc(sizeof(*conf));
    if (conf == NULL) { Py_DECREF(r); return NULL; }
    nn_init_conf(conf);
    table_set(conf, r); /* steals */
    sync_from_py(conf);
    return conf;
}

void nn_dump_conf(nn_def *conf, FILE *fp)
{
    PyObject *obj, *pyf;
    if (conf == NULL || fp == NULL) return;
    obj = ensure_handle(conf);
    if (obj == NULL) return;
    pyf = pyfile_from(fp);
    if (pyf == NULL) return;
    Py_XDECREF(call(mod_shim, "dump_conf_to",
                    Py_BuildValue("(OO)", obj, pyf)));
    Py_XDECREF(PyObject_CallMethod(pyf, "close", NULL));
    Py_DECREF(pyf);
}

void nn_free_conf(nn_def *neural)
{
    if (neural == NULL) return;
    nn_deinit_conf(neural);
    free(neural);
}

/* ---- kernel lifecycle ------------------------------------------------- */

void nn_free_kernel(nn_def *conf)
{
    PyObject *obj;
    if (conf == NULL) return;
    obj = table_get(conf);
    if (obj != NULL)
        Py_XDECREF(call(mod_shim, "free_kernel",
                        Py_BuildValue("(O)", obj)));
    conf->kernel = NULL;
}

BOOL nn_generate_kernel(nn_def *conf, ...)
{
    /* reference va list: UINT n_inputs, UINT n_hiddens, UINT n_outputs,
     * UINT *hiddens (libhpnn.c:954-980) */
    va_list ap;
    UINT n_in, n_hid, n_out, *hid, i;
    PyObject *obj, *list, *r;
    BOOL ok = FALSE;
    if (conf == NULL) return FALSE;
    obj = ensure_handle(conf);
    if (obj == NULL) return FALSE;
    va_start(ap, conf);
    n_in = va_arg(ap, UINT);
    n_hid = va_arg(ap, UINT);
    n_out = va_arg(ap, UINT);
    hid = va_arg(ap, UINT *);
    va_end(ap);
    if (n_hid == 0 || hid == NULL) return FALSE;
    list = PyList_New((Py_ssize_t)n_hid);
    if (list == NULL) { PyErr_Print(); return FALSE; }
    for (i = 0; i < n_hid; i++)
        PyList_SetItem(list, i, PyLong_FromUnsignedLong(hid[i]));
    r = call(mod_shim, "generate_kernel_dims",
             Py_BuildValue("(OIIN)", obj, n_in, n_out, list));
    if (r != NULL) {
        ok = (r == Py_True);
        Py_DECREF(r);
    }
    sync_from_py(conf); /* effective seed written back, kernel flag */
    return ok;
}

BOOL nn_load_kernel(nn_def *conf)
{
    PyObject *obj, *r;
    BOOL ok = FALSE;
    if (conf == NULL) return FALSE;
    obj = ensure_handle(conf);
    if (obj == NULL) return FALSE;
    r = call(mod_shim, "load_kernel_file", Py_BuildValue("(O)", obj));
    if (r != NULL) {
        ok = (r == Py_True);
        Py_DECREF(r);
    }
    sync_from_py(conf);
    return ok;
}

void nn_dump_kernel(nn_def *conf, FILE *output)
{
    PyObject *obj, *pyf;
    if (conf == NULL || output == NULL) return;
    obj = table_get(conf);
    if (obj == NULL) return;
    pyf = pyfile_from(output);
    if (pyf == NULL) return;
    Py_XDECREF(call(mod_shim, "dump_kernel_to",
                    Py_BuildValue("(OO)", obj, pyf)));
    Py_XDECREF(PyObject_CallMethod(pyf, "close", NULL));
    Py_DECREF(pyf);
}

/* ---- NN parameter access ---------------------------------------------- */

UINT nn_get_n_inputs(nn_def *conf)
{
    PyObject *obj, *r;
    UINT v = 0;
    if (conf == NULL) return 0;
    obj = table_get(conf);
    if (obj == NULL) return 0;
    r = PyObject_GetAttrString(obj, "n_inputs");
    if (r != NULL) { v = (UINT)PyLong_AsLong(r); Py_DECREF(r); }
    else PyErr_Print();
    return v;
}

UINT nn_get_n_hiddens(nn_def *conf)
{
    PyObject *obj;
    if (conf == NULL) return 0;
    obj = table_get(conf);
    if (obj == NULL) return 0;
    return (UINT)call_long(mod_shim, "get_n_hiddens",
                           Py_BuildValue("(O)", obj), 0);
}

UINT nn_get_n_outputs(nn_def *conf)
{
    PyObject *obj, *r;
    UINT v = 0;
    if (conf == NULL) return 0;
    obj = table_get(conf);
    if (obj == NULL) return 0;
    r = PyObject_GetAttrString(obj, "n_outputs");
    if (r != NULL) { v = (UINT)PyLong_AsLong(r); Py_DECREF(r); }
    else PyErr_Print();
    return v;
}

UINT nn_get_h_neurons(nn_def *conf, UINT layer)
{
    PyObject *obj;
    if (conf == NULL) return 0;
    obj = table_get(conf);
    if (obj == NULL) return 0;
    return (UINT)call_long(mod_shim, "get_h_neurons",
                           Py_BuildValue("(OI)", obj, layer), 0);
}

/* ---- sample I/O ------------------------------------------------------- */

BOOL nn_read_sample(CHAR *filename, DOUBLE **in, DOUBLE **out)
{
    PyObject *r, *li, *lo;
    Py_ssize_t n, i;
    if (filename == NULL || in == NULL || out == NULL) return FALSE;
    if (ensure_python() != 0) return FALSE;
    r = call(mod_shim, "read_sample_lists", Py_BuildValue("(s)", filename));
    if (r == NULL || r == Py_None) {
        Py_XDECREF(r);
        return FALSE;
    }
    li = PyTuple_GetItem(r, 0); /* borrowed */
    lo = PyTuple_GetItem(r, 1);
    if (li == NULL || lo == NULL) { Py_DECREF(r); return FALSE; }
    n = PyList_Size(li);
    ALLOC(*in, (UINT)n, DOUBLE);
    for (i = 0; i < n; i++)
        (*in)[i] = PyFloat_AsDouble(PyList_GetItem(li, i));
    n = PyList_Size(lo);
    ALLOC(*out, (UINT)n, DOUBLE);
    for (i = 0; i < n; i++)
        (*out)[i] = PyFloat_AsDouble(PyList_GetItem(lo, i));
    Py_DECREF(r);
    return TRUE;
}

/* ---- drivers ---------------------------------------------------------- */

BOOL nn_train_kernel(nn_def *conf)
{
    PyObject *obj;
    BOOL ok;
    if (conf == NULL) return FALSE;
    obj = table_get(conf);
    if (obj == NULL) return FALSE;
    ok = (BOOL)call_long(mod_shim, "train_kernel",
                         Py_BuildValue("(O)", obj), 0);
    sync_from_py(conf); /* seed 0 -> time() written back by the driver */
    return ok;
}

void nn_run_kernel(nn_def *conf)
{
    PyObject *obj;
    if (conf == NULL) return;
    obj = table_get(conf);
    if (obj == NULL) return;
    Py_XDECREF(call(mod_shim, "run_kernel", Py_BuildValue("(O)", obj)));
}
