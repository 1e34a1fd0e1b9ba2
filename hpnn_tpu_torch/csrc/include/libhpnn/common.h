/* libhpnn/common.h -- portability/macro layer of the PyTorch/CUDA port's
 * C API (the port's own copy of the JAX package's).
 *
 * Reference-compatible subset of the reference's include/libhpnn/common.h
 * (its L1 layer): the typedefs and helper macros that
 * the public header and the reference's client programs (tests/train_nn.c,
 * tests/run_nn.c, the tutorial tools) rely on.  Written fresh; each macro
 * keeps
 * the reference's observable semantics (cited) but not its implementation:
 * where the reference hand-rolls string walks we call libc.
 *
 * Deliberate deviations (documented):
 *  - STRDUP/STRLEN tolerate NULL sources (the reference dereferences and
 *    crashes; nothing can depend on that).
 *  - no glib flavor (USE_GLIB): libc only.
 *  - the CUDA alloc/copy macro family (common.h:298-578) is left out:
 *    the port's device buffers are PyTorch tensors, never handed to C.
 */
#ifndef LIBHPNN_COMMON_H
#define LIBHPNN_COMMON_H

#include <ctype.h>
#include <dirent.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

/* typedefs (reference common.h:146-160, libc flavor) */
#define DIR_S DIR
#define CHAR char
#define UCHAR unsigned char
#define SHORT short
#define UINT unsigned int
#define UINT64 uint64_t
#define DOUBLE double
#define BOOL int

#ifndef TRUE
#define TRUE (1==1)
#endif
#ifndef FALSE
#define FALSE (1==0)
#endif

#define TINY 1E-14

/* FUNCTION: best-effort current function name (common.h:60-71) */
#if defined(__GNUC__)
#define FUNCTION __PRETTY_FUNCTION__
#else
#define FUNCTION __func__
#endif

/* rank-0-only output: one process unless torch.distributed is active,
 * where printing is already rank-0-gated on the Python side -- so plain
 * fprintf is the correct single-binary behavior here
 * (reference common.h:81-86 gates on MPI_Comm_rank under _MPI) */
#define _OUT(_file,...) do{ fprintf((_file), __VA_ARGS__); }while(0)

/* character tests / scanners (common.h:166-171, 250-262) */
#define STRFIND(a,b) strstr(b,a)
#define ISDIGIT(a) isdigit((unsigned char)(a))
#define ISGRAPH(a) isgraph((unsigned char)(a))
#define ISSPACE(a) isspace((unsigned char)(a))
#define STR2ULL strtoull
#define STR2D strtod
#define SKIP_BLANK(pointer) \
    while((!ISGRAPH(*pointer))&&(*pointer!='\n')&&(*pointer!='\0')) pointer++
#define SKIP_NUM(pointer) \
    while((ISDIGIT(*pointer))&&(*pointer!='\n')&&(*pointer!='\0')) pointer++
#define STR_CLEAN(pointer) do{\
    CHAR *_sc=(pointer);\
    while(*_sc!='\0'){\
        if(*_sc=='\t'||*_sc==' '||*_sc=='\n'||*_sc=='#') *_sc='\0';\
        else _sc++;\
    }\
}while(0)

/* allocation with error-exit (common.h:161-167, 172-175) */
#define ALLOC(pointer,size,type) do{\
    pointer=(type *)calloc((size_t)(size),sizeof(type));\
    if(pointer==NULL){\
        _OUT(stderr,"Alloc error (function %s, line %i)\n",FUNCTION,__LINE__);\
        exit(-1);\
    }\
}while(0)
#define FREE(pointer) do{\
    free((void *)(pointer));\
    pointer=NULL;\
}while(0)

/* string length/dup/cat; empty source -> NULL dest, like the reference
 * (common.h:176-190: STRDUP of "" leaves dest=NULL) */
#define STRLEN(src,len) do{\
    if((src)!=NULL) len=(UINT)strlen(src);\
}while(0)
#define STRDUP(src,dest) do{\
    dest=NULL;\
    if((src)!=NULL&&(src)[0]!='\0'){\
        dest=strdup(src);\
        if(dest==NULL){\
            _OUT(stderr,"Alloc error (function %s, line %i)\n",\
                 FUNCTION,__LINE__);\
            exit(-1);\
        }\
    }\
}while(0)
#define STRDUP_REPORT(src,dest,mem) do{\
    STRDUP(src,dest);\
    if((dest)!=NULL) mem+=strlen(dest)*sizeof(CHAR);\
}while(0)
#define STRCAT(dest,src1,src2) do{\
    dest=NULL;\
    if((src1)!=NULL&&(src2)!=NULL&&(src2)[0]!='\0'){\
        dest=(CHAR *)malloc(strlen(src1)+strlen(src2)+1);\
        if(dest==NULL){\
            _OUT(stderr,"Alloc error (function %s, line %i)\n",\
                 FUNCTION,__LINE__);\
            exit(-1);\
        }\
        strcpy(dest,src1);\
        strcat(dest,src2);\
    }\
}while(0)
#define ALLOC_REPORT(pointer,size,type,mem) do{\
    ALLOC(pointer,size,type);\
    mem+=(size)*sizeof(type);\
}while(0)

/* line reading (common.h:72-76): getline wrapper */
#define PREP_READLINE() size_t _readline_len=0
#define READLINE(fp,buffer) do{\
    ssize_t _rl_count;\
    _rl_count=getline(&buffer,&_readline_len,fp);\
    (void)_rl_count;\
}while(0)
#define GET_LAST_LINE(fp,buffer) do{\
    fseek(fp,-2,SEEK_END);\
    while(fgetc(fp)!='\n') fseek(fp,-2,SEEK_CUR);\
    fseek(fp,+1,SEEK_CUR);\
    READLINE(fp,buffer);\
}while(0)

/* numeric field scanners (common.h:269-274) */
#define GET_UINT(i,in,out) do{ i=(UINT)STR2ULL(in,&(out),10); }while(0)
#define GET_DOUBLE(d,in,out) do{ d=(DOUBLE)STR2D(in,&(out)); }while(0)
#define ARRAY_CP(src,dest,n) do{\
    if((src)!=NULL){\
        UINT _acp;\
        for(_acp=0;_acp<(UINT)(n);_acp++) (dest)[_acp]=(src)[_acp];\
    }\
}while(0)

/* directory iteration (common.h:225-243) */
#define GET_CWD(cwd) do{ cwd=getcwd(NULL,0); }while(0)
#define OPEN_DIR(dir,path) do{ dir=opendir(path); }while(0)
#define FILE_FROM_DIR(dir,file) do{\
    struct dirent *_ffd_entry;\
    _ffd_entry=readdir(dir);\
    if(_ffd_entry==NULL) file=NULL;\
    else STRDUP(_ffd_entry->d_name,file);\
}while(0)
#define CLOSE_DIR(dir,ok) do{ ok=closedir(dir); }while(0)

/* NULL guards (common.h:282-296) */
#define QUOTE(a) #a
#define ASSERTPTR(pointer,retval) do{\
    if((pointer)==NULL){\
        _OUT(stderr,"Error: NULL pointer (function %s, line %i):\n%s=NULL\n",\
            FUNCTION,__LINE__,QUOTE(pointer));\
        return retval;\
    }\
}while(0)
#define ASSERT_GOTO(pointer,label) do{\
    if((pointer)==NULL){\
        _OUT(stderr,"Error: NULL pointer (function %s, line %i):\n%s=NULL\n",\
            FUNCTION,__LINE__,QUOTE(pointer));\
        goto label;\
    }\
}while(0)

/* device runtime handle (common.h:580-605).  The port's streams and
 * library handles are PyTorch's; the struct keeps the reference's field
 * names with opaque pointers so client code that only stores/queries it
 * still compiles.  mem_model: the cards of a host reach each other
 * (NVLink), "P2P". */
typedef enum {
    CUDAS_MEM_NONE=0,
    CUDAS_MEM_EXP=1,
    CUDAS_MEM_P2P=2,
    CUDAS_MEM_CMM=3,
} cudas_mem;
typedef struct {
    UINT n_gpu;            /* devices of the runtime's kind */
    void *cuda_handle;     /* PyTorch's; always NULL here */
    UINT cuda_n_streams;   /* -S knob (the row-sharding degree) */
    void *cuda_streams;    /* PyTorch's; always NULL here */
    cudas_mem mem_model;
} cudastreams;

#endif /* LIBHPNN_COMMON_H */
