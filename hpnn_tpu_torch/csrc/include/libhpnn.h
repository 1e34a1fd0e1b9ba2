/* libhpnn.h -- full public C API of the PyTorch/CUDA port
 * (hpnn_tpu_torch), the port's own copy of the JAX package's header.
 *
 * Drop-in compatible with the reference header (include/libhpnn.h):
 * every `_NN(a,b)` entry point, type, enum and constant a client program
 * can reference is declared here with the reference's exact prototype,
 * so C programs of the public API (native/train_nn.c, native/run_nn.c)
 * compile UNMODIFIED against this header and link against
 * libhpnn_tpu_torch-<sha16>.so (csrc/hpnn_shim.c, built by
 * hpnn_tpu_torch/ops/build.py), which serves every call from the port
 * through an embedded CPython interpreter.
 *
 * The nn_def struct is concrete, with the reference's field layout
 * (libhpnn.h:78-89): `kernel` is opaque (it holds the Python-side
 * handle instead of a kernel_ann*), every other field is a live C
 * mirror kept in sync by the _NN(set/get,...) accessors.
 */
#ifndef LIBHPNN_H
#define LIBHPNN_H

#include <libhpnn/common.h>

#ifdef __cplusplus
extern "C" {
#endif

/* library capabilities (reference libhpnn.h:26-35 + the port's) */
typedef enum {
    NN_CAP_NONE=0,
    NN_CAP_OMP=(1<<0),
    NN_CAP_MPI=(1<<1),
    NN_CAP_CUDA=(1<<2),
    NN_CAP_CUBLAS=(1<<3),
    /*(1<<4) reserved (OCL in the reference)*/
    NN_CAP_PBLAS=(1<<5),
    NN_CAP_SBLAS=(1<<6),
    /*port additions, disjoint from the reference bits (runtime.py):
      computed by PyTorch; float64 throughout.  NN_CAP_CUDA above is set
      when a GPU is visible.*/
    NN_CAP_TORCH=(1<<8),
    NN_CAP_X64=(1<<10),
} nn_cap;

/* runtime parameters (reference libhpnn.h:39-47) */
typedef struct {
    nn_cap capability;
    SHORT nn_verbose;
    BOOL  nn_dry;
    UINT  nn_num_threads;
    UINT  nn_num_blas;
    UINT  nn_num_tasks;
    cudastreams cudas;
} nn_runtime;

/* neural network types (reference libhpnn.h:51-57) */
typedef enum {
    NN_TYPE_ANN = 0,
    NN_TYPE_LNN = 1,
    NN_TYPE_SNN = 2,
    NN_TYPE_UKN =-1,
} nn_type;

/* training types (reference libhpnn.h:61-67) */
typedef enum {
    NN_TRAIN_BP  = 0,
    NN_TRAIN_BPM = 1,
    NN_TRAIN_CG  = 2,
    NN_TRAIN_SPLX =3,
    NN_TRAIN_UKN =-1,
} nn_train;

/* convergence constants (reference libhpnn.h:67-74) */
#define BP_LEARN_RATE 0.001
#define MIN_BP_ITER 31
#define MAX_BP_ITER 102399
#define DELTA_BP 1E-6
#define BPM_LEARN_RATE 0.0005
#define MIN_BPM_ITER 15
#define MAX_BPM_ITER 102399
#define DELTA_BPM 1E-6

/* NN definition handle (reference libhpnn.h:78-89).  Concrete so client
 * programs may inspect fields; `kernel` holds the engine-side handle. */
typedef struct {
    nn_runtime *rr;
    CHAR     *name;
    nn_type   type;
    BOOL need_init;
    UINT      seed;
    void   *kernel;
    CHAR *f_kernel;
    nn_train train;
    CHAR  *samples;
    CHAR    *tests;
} nn_def;

#define _NN(a,b) nn_##a##_##b

/* verbosity-aware output macros (reference libhpnn.h:93-122) */
#define NN_DBG(_file,...) do{\
    if((_NN(return,verbose)())>2){\
        _OUT((_file),"NN(DBG): ");\
        _OUT((_file), __VA_ARGS__);\
    }\
}while(0)
#define NN_OUT(_file,...) do{\
    if((_NN(return,verbose)())>1){\
        _OUT((_file),"NN: ");\
        _OUT((_file), __VA_ARGS__);\
    }\
}while(0)
#define NN_COUT(_file,...) do{\
    if((_NN(return,verbose)())>1){\
        _OUT((_file), __VA_ARGS__);\
    }\
}while(0)
#define NN_WARN(_file,...) do{\
    if((_NN(return,verbose)())>0){\
        _OUT((_file),"NN(WARN): ");\
        _OUT((_file), __VA_ARGS__);\
    }\
}while(0)
#define NN_ERROR(_file,...) do{\
    _OUT((_file),"NN(ERR): ");\
    _OUT((_file), __VA_ARGS__);\
}while(0)
#define NN_WRITE _OUT

/* initialize library (reference libhpnn.h:126-148) */
void _NN(inc,verbose)(void);
void _NN(dec,verbose)(void);
void _NN(set,verbose)(SHORT verbosity);
void _NN(get,verbose)(SHORT *verbosity);
SHORT _NN(return,verbose)(void);
void _NN(toggle,dry)(void);
void _NN(get,capabilities)(nn_cap *capabilities);
void _NN(unset,capability)(nn_cap capability);
nn_cap _NN(return,capabilities)(void);
BOOL _NN(init,OMP)(void);
BOOL _NN(init,MPI)(void);
BOOL _NN(init,CUDA)(void);
BOOL _NN(init,BLAS)(void);
int _NN(init,all)(UINT init_verbose);
BOOL _NN(deinit,OMP)(void);
BOOL _NN(deinit,MPI)(void);
BOOL _NN(deinit,CUDA)(void);
BOOL _NN(deinit,BLAS)(void);
int  _NN(deinit,all)(void);

/* set/get lib parameters (reference libhpnn.h:152-167) */
BOOL _NN(set,omp_threads)(UINT n_threads);
BOOL _NN(get,omp_threads)(UINT *n_threads);
int _NN(return,omp_threads)(void);
BOOL _NN(set,mpi_tasks)(UINT n_tasks);
BOOL _NN(get,mpi_tasks)(UINT *n_tasks);
BOOL _NN(get,curr_mpi_task)(UINT *task);
BOOL _NN(set,n_gpu)(UINT n_gpu);
BOOL _NN(get,n_gpu)(UINT *n_gpu);
BOOL _NN(set,cuda_streams)(UINT n_streams);
BOOL _NN(get,cuda_streams)(UINT *n_streams);
BOOL _NN(set,omp_blas)(UINT n_blas);
BOOL _NN(get,omp_blas)(UINT *n_blas);
cudastreams *_NN(return,cudas)(void);

/* configuration (reference libhpnn.h:171-204) */
void _NN(init,conf)(nn_def *conf);
void _NN(deinit,conf)(nn_def *conf);
void _NN(set,name)(nn_def *conf,const CHAR *name);
void _NN(get,name)(nn_def *conf,CHAR **name);
char *_NN(return,name)(nn_def *conf);
void _NN(set,type)(nn_def *conf,nn_type type);
void _NN(get,type)(nn_def *conf,nn_type *type);
nn_type _NN(return,type)(nn_def *conf);
void _NN(set,need_init)(nn_def *conf,BOOL need_init);
void _NN(get,need_init)(nn_def *conf,BOOL *need_init);
BOOL _NN(return,need_init)(nn_def *conf);
void _NN(set,seed)(nn_def *conf,UINT seed);
void _NN(get,seed)(nn_def *conf,UINT *seed);
UINT _NN(return,seed)(nn_def *conf);
void _NN(set,kernel_filename)(nn_def *conf,CHAR *f_kernel);
void _NN(get,kernel_filename)(nn_def *conf,CHAR **f_kernel);
char *_NN(return,kernel_filename)(nn_def *conf);
void _NN(set,train)(nn_def *conf,nn_train train);
void _NN(get,train)(nn_def *conf,nn_train *train);
nn_train _NN(return,train)(nn_def *conf);
void _NN(set,samples_directory)(nn_def *conf,CHAR *samples);
void _NN(get,samples_directory)(nn_def *conf,CHAR **samples);
char *_NN(return,samples_directory)(nn_def *conf);
void _NN(set,tests_directory)(nn_def *conf,CHAR *tests);
void _NN(get,tests_directory)(nn_def *conf,CHAR **tests);
char *_NN(return,tests_directory)(nn_def *conf);
nn_def *_NN(load,conf)(const CHAR *filename);
void _NN(dump,conf)(nn_def *conf,FILE *fp);

/* manipulate NN kernel (reference libhpnn.h:208-212) */
void _NN(free,kernel)(nn_def *conf);
BOOL _NN(generate,kernel)(nn_def *conf,...);
BOOL _NN(load,kernel)(nn_def *conf);
void _NN(dump,kernel)(nn_def *conf, FILE *output);

/* access NN parameters (reference libhpnn.h:216-219) */
UINT _NN(get,n_inputs)(nn_def *conf);
UINT _NN(get,n_hiddens)(nn_def *conf);
UINT _NN(get,n_outputs)(nn_def *conf);
UINT _NN(get,h_neurons)(nn_def *conf,UINT layer);

/* sample I/O (reference libhpnn.h:223) */
BOOL _NN(read,sample)(CHAR *filename,DOUBLE **in,DOUBLE **out);

/* execute NN OP (reference libhpnn.h:227-228) */
BOOL _NN(train,kernel)(nn_def *conf);
void _NN(run,kernel)(nn_def *conf);

/* rebuild extension: free a handle returned by _NN(load,conf) in one
 * call (equivalent to _NN(deinit,conf)(x); FREE(x)) */
void nn_free_conf(nn_def *neural);

#ifdef __cplusplus
}
#endif
#endif /* LIBHPNN_H */
